from .adamw import AdamW, apply_updates, cosine_schedule, global_norm
from .grad_compress import (compress_grads, compression_ratio,
                            init_error_feedback)

__all__ = ["AdamW", "apply_updates", "compress_grads", "compression_ratio",
           "cosine_schedule", "global_norm", "init_error_feedback"]
