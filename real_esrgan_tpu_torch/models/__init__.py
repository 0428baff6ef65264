from real_esrgan_tpu_torch.models.rrdbnet import (  # noqa: F401
    RRDB, Generator, ResidualDenseBlock, pixel_unshuffle,
)
