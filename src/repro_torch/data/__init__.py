"""repro_torch.data — synthetic batches and the deterministic token
pipeline: the port of the JAX package's ``data``."""
from repro_torch.data.batches import (ShapeDtypeStruct,  # noqa: F401
                                      input_specs, make_batch)
from repro_torch.data.pipeline import SyntheticTokenPipeline  # noqa: F401
