"""Automatic mixed precision (a copy of
``paddle_tpu/contrib/mixed_precision``), bf16 by default."""
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import rewrite_program  # noqa: F401
