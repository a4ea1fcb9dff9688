"""Models: the multiplexed backbone; the image models are
``repro_torch.models.image``."""
from repro_torch.models.backbone import Backbone

__all__ = ["Backbone"]
