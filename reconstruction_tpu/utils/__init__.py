from reconstruction_tpu.utils.timing import Timer  # noqa: F401
from reconstruction_tpu.utils.logging import get_logger, StageStats  # noqa: F401
