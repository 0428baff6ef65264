from real_esrgan_tpu_torch.models.discriminator import UNetDiscriminator  # noqa: F401
from real_esrgan_tpu_torch.models.rrdbnet import (  # noqa: F401
    RRDB, Generator, ResidualDenseBlock, TrunkFeatures, pixel_unshuffle, trunk_feature_params,
)
from real_esrgan_tpu_torch.models.vgg import VGG19Features  # noqa: F401
