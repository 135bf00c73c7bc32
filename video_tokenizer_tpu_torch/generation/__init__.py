from .generate import generate, sample_from_logits, top_k_top_p_filtering  # noqa: F401
from .speculative import self_draft, speculative_generate  # noqa: F401
