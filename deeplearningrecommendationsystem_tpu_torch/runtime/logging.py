"""Host-side reporting in the reference's output format.

The JAX package's ``runtime/logging.py``, its text character for character:
the per-epoch metric history comes back from the trainer as arrays and is
printed after the run in the layout of the reference's epoch report
(trainer/trainer.py:121-146) and ranking report (evaluator/ranking.py:143-150),
so the outputs of the two packages and the reference compare line by line.
"""

from __future__ import annotations

from typing import Dict


def print_epoch(epoch: int, h: Dict, i: int) -> None:
    def g(key):
        return float(h[key][i]) if key in h else float("nan")

    print(
        f"""
        Epoch {epoch}:
          - Training Loss: {g('train_loss')}
          - Valid Loss: {g('valid_loss')}
          - Test Loss: {g('test_loss')}

          - Training Accuracy: {g('train_accuracy')}
          - Valid Accuracy: {g('valid_accuracy')}
          - Test Accuracy: {g('test_accuracy')}

          - Training Precision: {g('train_precision')}
          - Valid Precision: {g('valid_precision')}
          - Test Precision: {g('test_precision')}

          - Training Recall: {g('train_recall')}
          - Valid Recall: {g('valid_recall')}
          - Test Recall: {g('test_recall')}

          - Training F1 Score: {g('train_f1')}
          - Valid F1 Score: {g('valid_f1')}
          - Test F1 Score: {g('test_f1')}

          - Training ROC AUC Score: {g('train_auc')}
          - Valid ROC AUC Score: {g('valid_auc')}
          - Test ROC AUC Score: {g('test_auc')}
        """
    )


def print_ranking(metrics: Dict[str, float], k: int) -> None:
    print(
        f"""
                - Precision@{k}:  {metrics['precision']}
                - Recall@{k}:  {metrics['recall']}
                - F1 Score@{k}:  {metrics['f1']}
                - MAP@{k}: {metrics['map']}
                - Mean NDCG@{k}: {metrics['ndcg']}
                - MRR: {metrics['mrr']}
                """
    )


def print_report(result, k: int = 50, epoch_stride: int = 0) -> None:
    """Final report: last-epoch metrics (+ optionally every Nth epoch) and
    valid/test ranking metrics."""
    h = result.history
    n = len(h["train_loss"])
    if epoch_stride:
        for i in range(0, n, epoch_stride):
            print_epoch(i + 1, h, i)
    print_epoch(n, h, n - 1)
    if "valid" in result.ranking:
        print("Validation ranking metrics:")
        print_ranking(result.ranking["valid"], k)
    if "test" in result.ranking:
        print("Test ranking metrics:")
        print_ranking(result.ranking["test"], k)
    print(
        f"[{result.model}] {result.train_examples} examples x {result.epochs} epochs "
        f"in {result.train_time_s:.2f}s = {result.examples_per_sec:,.0f} examples/s"
    )
