"""Model builders (the subset of ``paddle_tpu.models`` the port carries)."""

from .common import ModelSpec  # noqa: F401
from . import bert  # noqa: F401
from . import books  # noqa: F401
from . import common  # noqa: F401
from . import deepfm  # noqa: F401
from . import label_semantic_roles  # noqa: F401
from . import machine_translation  # noqa: F401
from . import mnist  # noqa: F401
from . import ocr_ctc  # noqa: F401
from . import resnet  # noqa: F401
from . import se_resnext  # noqa: F401
from . import ssd  # noqa: F401
from . import stacked_lstm  # noqa: F401
from . import transformer  # noqa: F401
from . import vgg  # noqa: F401
from . import word2vec  # noqa: F401
