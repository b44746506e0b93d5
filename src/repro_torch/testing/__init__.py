"""repro_torch.testing — the port's differential-testing subsystem, the
counterpart of the JAX package's ``repro.testing``:

  oracle       pure-NumPy ISA interpreter + Pattern loop-nest evaluator
  fuzzer       seeded generator of legal Patterns + environments, mixed
               flush windows and traffic traces (the reference's draws)
  harness      engine-config-matrix parity checks against the oracles
  conformance  the paper's 12 Table-1 benchmark kernels as Patterns

Quick parity check for any Pattern:

    from repro_torch.testing import harness
    harness.check_pattern_parity(pattern, env, n=n, device="cpu")

``pattern_from`` rebuilds a port ``Pattern`` from any object with the same
class names and fields (a ``repro.core.compiler.Pattern``, say), so tests
can feed the reference's patterns to the port without the port importing
the reference.
"""
from repro_torch.testing.conformance import all_names as conformance_names
from repro_torch.testing.conformance import build as build_conformance
from repro_torch.testing.fuzzer import (FuzzCase, MixedFlushCase,
                                        generate_case, generate_mixed_case,
                                        generate_traffic_case)
from repro_torch.testing.harness import (CONFIG_MATRIX, EAGER_CONFIGS,
                                         JIT_CONFIGS, EngineConfig,
                                         ParityError, check_app_parity,
                                         check_case_parity,
                                         check_embedding_parity,
                                         check_kv_parity,
                                         check_mixed_flush_parity,
                                         check_pattern_parity,
                                         check_scheduler_parity,
                                         check_sharded_parity,
                                         check_traffic_parity,
                                         default_sharded_cases,
                                         rotating_configs, run_engine_tiled)
from repro_torch.testing.oracle import (NP_DTYPES, OracleEngine, eval_expr,
                                        oracle_run_tiled, run_pattern)
from repro_torch.testing.patterns import pattern_from

__all__ = [
    "conformance_names", "build_conformance", "FuzzCase", "generate_case",
    "MixedFlushCase", "generate_mixed_case", "check_mixed_flush_parity",
    "generate_traffic_case", "check_traffic_parity",
    "CONFIG_MATRIX", "EAGER_CONFIGS", "JIT_CONFIGS", "EngineConfig",
    "ParityError", "check_app_parity", "check_case_parity",
    "check_embedding_parity", "check_kv_parity",
    "check_pattern_parity",
    "check_scheduler_parity", "check_sharded_parity",
    "default_sharded_cases",
    "rotating_configs", "run_engine_tiled", "NP_DTYPES", "OracleEngine",
    "eval_expr", "oracle_run_tiled", "run_pattern", "pattern_from",
]
