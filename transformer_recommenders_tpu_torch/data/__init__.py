from transformer_recommenders_tpu_torch.data.dataset import SeqData
from transformer_recommenders_tpu_torch.data.module import SeqDataModule

__all__ = ["SeqData", "SeqDataModule"]
