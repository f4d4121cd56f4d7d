from .sample import sample_tokens, verify_draft  # noqa: F401
from .topk import sorted_topk  # noqa: F401
