"""A module fixture's result computed once a test run, across xdist
workers (the pattern pytest-xdist documents for a fixture that executes
once).

Under ``--dist load`` xdist deals one module's tests to several workers,
and each worker would run the module's fixture again: respawn the gloo
worlds and the reference's subprocesses, which then compete for the same
CPUs. ``once`` lets the first worker that asks compute the result under a
``filelock.FileLock`` and pickle it into the directory every worker of
the run shares (``tmp_path_factory.getbasetemp().parent``, which no later
run sees); the others wait on the lock and load it. If the computation
raises, the first worker writes the failure, and every worker that asks
fails with the same text, rather than hanging or spawning again. Without
xdist the module fixture already runs once, so ``once`` just computes.

Each spawning fixture of the port's tests goes through it::

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        return once(tmp_path_factory, "train_rwkv", lambda:
                    ref.run_cases(CASES, tmp_path_factory.mktemp("rwkv")))

To see that a fixture set up once, run its module with ``-n 4 --dist
load --durations=0``: one worker's first test shows the long set-up,
every other test's set-up is under a second.
"""
import os
import pickle
import traceback

import pytest
from filelock import FileLock, Timeout

# a waiting worker gives up after this long (the computations hold their
# own, shorter, limits: a spawn's join and the reference's subprocess)
WAIT_LIMIT = 1200.0


def once(tmp_path_factory, key: str, compute):
    """``compute()``'s result, computed by one worker of the run and
    loaded by the others. ``key`` names the result within the run: the
    module's fixture and every option that changes what it computes."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    path = tmp_path_factory.getbasetemp().parent / f"once-{key}.pkl"
    try:
        with FileLock(f"{path}.lock", timeout=WAIT_LIMIT):
            if not path.is_file():
                try:
                    record = ("ok", compute())
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException:      # pytest.fail's too
                    record = ("failed", traceback.format_exc()[-8000:])
                path.write_bytes(pickle.dumps(record))
            status, value = pickle.loads(path.read_bytes())
    except Timeout:
        pytest.fail(f"{key}: waited {WAIT_LIMIT:.0f} s for another "
                    f"worker's result", pytrace=False)
    if status != "ok":
        pytest.fail(f"{key} failed on the worker that computed it:\n"
                    f"{value}", pytrace=False)
    return value
