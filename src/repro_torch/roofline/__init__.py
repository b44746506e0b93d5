"""repro_torch.roofline — roofline terms of a step on the H100: the port
of the JAX package's ``roofline``."""
from repro_torch.roofline.analysis import (HW, active_param_fraction,  # noqa: F401
                                           analyze_step, count_params,
                                           model_flops, roofline_terms)
