from transformer_recommenders_tpu_torch.native.build import load_native_sampler

__all__ = ["load_native_sampler"]
