from transeditor_tpu_torch.zoo.backbones import (
    AlexNetFeatures,
    VGGFeatures,
    VGG16_TAPS,
    VGG19_TAPS,
)
from transeditor_tpu_torch.zoo.lpips import LPIPS, load_lpips_params
