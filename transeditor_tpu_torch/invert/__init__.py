from transeditor_tpu_torch.invert.projector import (
    ProjectorConfig,
    estimate_latent_stats,
    project,
)
