"""repro_torch.optim — AdamW with bf16 moments, LR schedules, int8 block
gradient compression and global-norm clipping: the port of the JAX
package's ``optim``."""
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.compress import (compress_grads,  # noqa: F401
                                        decompress_grads, global_norm_clip)
from repro_torch.optim.schedules import make_schedule  # noqa: F401
