"""Models: the dense multiplexed backbone."""
from repro_torch.models.backbone import Backbone

__all__ = ["Backbone"]
