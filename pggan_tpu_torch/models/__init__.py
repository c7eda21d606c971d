from pggan_tpu_torch.models.generator import Generator

__all__ = ["Generator"]
