from deeplearningrecommendationsystem_tpu_torch.runtime.logging import (
    print_epoch,
    print_ranking,
    print_report,
)
from deeplearningrecommendationsystem_tpu_torch.runtime.plotting import plot_history

__all__ = ["print_epoch", "print_ranking", "print_report", "plot_history"]
