"""``tests/spawn_once.py``: a module fixture's result computed by one
xdist worker of a run and loaded by the others, a failure raised on
every worker with the same text. Two workers are two ``tmp_path_factory``
stand-ins whose base temp directories share a parent, as xdist's do."""
import pytest

from spawn_once import once


class _Factory:
    """``tmp_path_factory`` of one worker: its base temp directory."""

    def __init__(self, base):
        self.base = base

    def getbasetemp(self):
        return self.base


@pytest.fixture
def workers(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw0")
    return [_Factory(tmp_path / f"popen-gw{i}") for i in range(3)]


def test_the_first_worker_computes_and_the_others_load(workers):
    calls = []

    def compute():
        calls.append(1)
        return {"loss": [5.5, 5.25], "ranks": list(range(4))}
    got = [once(w, "runs", compute) for w in workers]
    assert calls == [1]
    assert got[0] == got[1] == got[2] == \
        {"loss": [5.5, 5.25], "ranks": list(range(4))}


def test_keys_keep_results_apart(workers):
    assert once(workers[0], "a", lambda: 1) == 1
    assert once(workers[1], "b", lambda: 2) == 2
    assert once(workers[2], "a", lambda: 3) == 1


def test_a_failure_fails_every_worker_with_its_text(workers):
    calls = []

    def compute():
        calls.append(1)
        raise RuntimeError("rank 2 died")
    texts = []
    for w in workers:
        with pytest.raises(pytest.fail.Exception) as e:
            once(w, "runs", compute)
        texts.append(str(e.value))
    assert calls == [1]
    assert "rank 2 died" in texts[0] and texts[0] == texts[1] == texts[2]


def test_without_xdist_it_just_computes(tmp_path, monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_WORKER", raising=False)
    calls = []
    for _ in range(2):
        assert once(_Factory(tmp_path), "runs",
                    lambda: calls.append(1) or 7) == 7
    assert calls == [1, 1]
    assert not list(tmp_path.iterdir())
