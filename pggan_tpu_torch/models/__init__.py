from pggan_tpu_torch.models.discriminator import Discriminator
from pggan_tpu_torch.models.generator import Generator

__all__ = ["Discriminator", "Generator"]
