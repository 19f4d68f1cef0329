"""The parallel layer: a ``("data", "model")`` device mesh over one process
per rank, row-sharded (EP) embedding tables and sharded serving, on
``torch.distributed`` (the JAX package's ``parallel/``)."""

from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    data_sharding,
    replicated,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.data import pad_and_shard
from deeplearningrecommendationsystem_tpu_torch.parallel.ep import (
    EP_TABLE_KEYS,
    EmbeddingPartitioning,
    embedding_partitioning,
    gather_rows,
    shard_model_tables,
    unshard_model_tables,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.embedding import (
    ShardedEmbedding,
    shard_table,
    sharded_gather,
    sharded_gather_scatter,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.serving import (
    sharded_catalog_topk,
    sharded_feature_topk,
    sharded_topk,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "data_sharding",
    "replicated",
    "pad_and_shard",
    "ShardedEmbedding",
    "EP_TABLE_KEYS",
    "EmbeddingPartitioning",
    "embedding_partitioning",
    "gather_rows",
    "shard_model_tables",
    "unshard_model_tables",
    "shard_table",
    "sharded_gather",
    "sharded_gather_scatter",
    "sharded_catalog_topk",
    "sharded_feature_topk",
    "sharded_topk",
]
