"""The parallel layer on ``torch.distributed``: a (data, model) process
mesh, collectives that autograd differentiates through, the row-sharded
table lookup and top-k, and the sharded train steps."""

from transformer_recommenders_tpu_torch.parallel.embedding import sharded_table_lookup
from transformer_recommenders_tpu_torch.parallel.mesh import create_mesh
from transformer_recommenders_tpu_torch.parallel.topk_sharded import sharded_topk

__all__ = ["create_mesh", "sharded_table_lookup", "sharded_topk"]
