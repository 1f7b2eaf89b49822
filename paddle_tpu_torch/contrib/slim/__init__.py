from .prune import Pruner, sensitivity  # noqa: F401
from .distill import soft_label_loss, fsp_loss  # noqa: F401
