"""The port's fault injection (``evox_tpu_torch/resilience/faults.py``,
``schedule.py``) and resume scan against the JAX package's: the schedule
audit's ``ValueError`` messages string for string, the injected fitness
rows and canary bit for bit, ``FaultyStore``'s fired faults, the retry
predicate's verdicts, and ``scan_checkpoints``' quarantine decisions on a
directory of torn and bit-flipped archives written by both packages.

Every comparison is exact (the inner problems here return a column of the
population, so no reduction order is involved)."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from evox_tpu.core import Problem as JProblem  # noqa: E402
from evox_tpu.core import State as JState  # noqa: E402
from evox_tpu.resilience import FaultyProblem as JFaultyProblem  # noqa: E402
from evox_tpu.resilience import FaultyStore as JFaultyStore  # noqa: E402
from evox_tpu.resilience import RetryPolicy as JRetryPolicy  # noqa: E402
from evox_tpu.resilience import default_retryable as jdefault_retryable  # noqa: E402
from evox_tpu.resilience import scan_checkpoints as jscan  # noqa: E402
from evox_tpu.resilience import validate_schedule as jvalidate  # noqa: E402
from evox_tpu.utils import checkpoint as jckpt  # noqa: E402

from evox_tpu_torch.core import Problem, State  # noqa: E402
from evox_tpu_torch.resilience import (  # noqa: E402
    FaultyProblem,
    FaultyStore,
    InjectedBackendError,
    InjectedFatalError,
    InjectedStorageError,
    RetryPolicy,
    WatchdogTimeout,
    default_retryable,
    latest_checkpoint,
    scan_checkpoints,
    validate_schedule,
)
from evox_tpu_torch.utils import save_state  # noqa: E402


class FirstColumn(Problem):
    """Fitness = the first coordinate (no arithmetic: equal in both
    packages by construction)."""

    def setup(self, key):
        return State()

    def evaluate(self, state, pop):
        return pop[:, 0].clone(), state


class JFirstColumn(JProblem):
    def setup(self, key):
        return JState()

    def evaluate(self, state, pop):
        return pop[:, 0], state


# ---------------------------------------------------------------------------
# the schedule audit
# ---------------------------------------------------------------------------

BAD_PLANS = [
    dict(nan_generations=[-1]),
    dict(inf_generations=[3, -2]),
    dict(corrupt_generations=[-1]),
    dict(error_generations=[-4]),
    dict(fatal_generations=[-1]),
    dict(delay_generations=[-1]),
    dict(sigterm_generations=[-1]),
    dict(nan_rows=-1),
    dict(inf_rows=-2),
    dict(error_times=-1),
    dict(delay_seconds=-0.5),
    dict(straggler_delay=-1.0),
    dict(kill_times=-1),
    dict(partition_seconds=-1.0),
    dict(plateau_until=5),
    dict(plateau_from=-1),
    dict(plateau_from=5, plateau_until=3),
    dict(dead_shards={0: [-1]}, shards=2),
    dict(dead_shards={-1: [1]}, shards=2),
    dict(dead_shards={2: [1]}, shards=2),
    dict(dead_shards={0: [1]}),
    dict(straggler_shards={3: [1]}, shards=2),
    dict(straggler_shards={0: [-3]}),
    dict(eval_deadline=0.0),
]


@pytest.mark.parametrize("plan", BAD_PLANS, ids=[",".join(p) for p in BAD_PLANS])
def test_schedule_audit_messages_equal_the_jax_packages(plan):
    with pytest.raises(ValueError) as mine:
        FaultyProblem(FirstColumn(), **plan)
    with pytest.raises(ValueError) as theirs:
        JFaultyProblem(JFirstColumn(), **plan)
    assert str(mine.value) == str(theirs.value)


STORE_PLANS = [
    dict(crash_saves=[-1]),
    dict(torn_fraction=-0.1),
    dict(crash_saves=[1], torn_saves=[1]),
    dict(enospc_saves=[2], eio_saves=[2]),
    dict(eio_saves=[0], flip_saves=[0]),
]


@pytest.mark.parametrize("plan", STORE_PLANS, ids=[",".join(p) for p in STORE_PLANS])
def test_store_audit_and_validate_schedule_equal_the_jax_packages(plan):
    with pytest.raises(ValueError) as mine:
        FaultyStore(**plan)
    with pytest.raises(ValueError) as theirs:
        JFaultyStore(**plan)
    assert str(mine.value) == str(theirs.value)
    msgs = []
    for f in (validate_schedule, jvalidate):
        with pytest.raises(ValueError) as e:
            f("Plan", fields={"a": 1, "zz": 2}, known=("a", "b"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert validate_schedule("P", indices={"x": [3, 1]}) == jvalidate("P", indices={"x": [3, 1]})


@pytest.mark.parametrize(
    "fleet",
    [dict(kill_process_at={0: [1]}), dict(partition_process_at={1: [2]}), dict(slow_process_at={0: [1]}),
     dict(lane_faults={3: {"nan_generations": [1]}})],
    ids=["kill", "partition", "slow", "lane"],
)
def test_fleet_and_lane_faults_are_refused_by_name(fleet):
    """Once refused by name, now ported: each plan is normalised as the JAX
    package normalises it, makes the problem not capturable (a process
    fault is a host fault; a lane's NaN rows are device faults), and a
    malformed plan is refused with the JAX package's message (the
    torch.distributed rank where it names jax.process_index())."""
    name = next(iter(fleet))
    if name == "lane_faults":
        prob = FaultyProblem(FirstColumn(), **fleet)
        assert prob.lane_faults[3]["nan_generations"] == (1,) and prob.capturable
        return
    prob = FaultyProblem(FirstColumn(), **fleet)
    assert getattr(prob, name) == getattr(JFaultyProblem(JFirstColumn(), **fleet), name)
    assert not prob.capturable
    for bad in ({name: {-1: [1]}}, {name: {0: [-3]}}):
        with pytest.raises(ValueError) as mine:
            FaultyProblem(FirstColumn(), **bad)
        with pytest.raises(ValueError) as theirs:
            JFaultyProblem(JFirstColumn(), **bad)
        assert str(mine.value) == str(theirs.value).replace("jax.process_index()", "torch.distributed rank")


# ---------------------------------------------------------------------------
# injected rows and the canary
# ---------------------------------------------------------------------------

DEVICE_PLAN = dict(
    nan_generations=(0, 2), nan_rows=2, inf_generations=(1, 2), inf_rows=3,
    plateau_from=2, plateau_until=4, plateau_floor=0.25, dead_shards={1: (1, 3)}, shards=4,
)


def _pop(g, n=16, d=6):
    return g.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("plan", [DEVICE_PLAN, dict(DEVICE_PLAN, shards=3), dict(nan_generations=(1,), nan_rows=40)])
def test_injected_rows_equal_the_jax_packages(plan):
    g = np.random.default_rng(1)
    mine = FaultyProblem(FirstColumn(), **plan)
    theirs = JFaultyProblem(JFirstColumn(), **plan)
    assert mine.capturable  # device faults only: tensor operations on the card
    ms = mine.setup(torch.tensor([0, 0]))
    ts = theirs.setup(jax.random.key(0))
    for _ in range(5):
        pop = _pop(g)
        fm, ms = mine.evaluate(ms, torch.from_numpy(pop))
        ft, ts = theirs.evaluate(ts, jnp.asarray(pop))
        np.testing.assert_array_equal(fm.numpy(), np.asarray(ft))
        assert int(ms.fault_generation) == int(ts.fault_generation)
        assert ms.fault_generation.dtype == torch.int32 and int(ms.fault_lane) == -1


def test_corruption_canary_and_host_faults_equal_the_jax_packages():
    """The attempt-counted corruption (a host fault: not capturable) fires
    for its first attempt and heals on the replay, as in the JAX package."""
    plan = dict(corrupt_generations=(1,), corrupt_times=1)
    mine = FaultyProblem(FirstColumn(), **plan)
    theirs = JFaultyProblem(JFirstColumn(), **plan)
    assert not mine.capturable
    pop = _pop(np.random.default_rng(2))
    ms0 = mine.setup(torch.tensor([0, 0]))
    ts0 = theirs.setup(jax.random.key(0))
    _, ms1 = mine.evaluate(ms0, torch.from_numpy(pop))
    _, ts1 = theirs.evaluate(ts0, jnp.asarray(pop))
    seen = []
    for _ in range(2):  # the first attempt, then a replay of eval 1
        _, ms2 = mine.evaluate(ms1, torch.from_numpy(pop))
        _, ts2 = theirs.evaluate(ts1, jnp.asarray(pop))
        seen.append((float(ms2.corruption), float(ts2.corruption)))
    assert np.isnan(seen[0][0]) and np.isnan(seen[0][1])
    assert seen[1] == (0.0, 0.0)
    assert mine.attempts("corrupt", 1) == theirs.attempts("corrupt", 1) == 2


def test_host_errors_reach_the_caller_as_themselves():
    mine = FaultyProblem(FirstColumn(), error_generations=(0,), fatal_generations=(1,))
    st = mine.setup(torch.tensor([0, 0]))
    pop = torch.from_numpy(_pop(np.random.default_rng(3)))
    with pytest.raises(InjectedBackendError, match=r"UNAVAILABLE: injected backend loss \(fault schedule\) \[eval 0\]") as e:
        mine.evaluate(st, pop)
    assert default_retryable(e.value)
    _, st = mine.evaluate(st, pop)  # the outage passed (error_times=1)
    with pytest.raises(InjectedFatalError, match="NONRETRYABLE") as e:
        mine.evaluate(st, pop)
    assert not default_retryable(e.value)
    # The JAX package's comes wrapped in an XLA runtime error; both
    # predicates agree on both forms.
    theirs = JFaultyProblem(JFirstColumn(), error_generations=(0,), fatal_generations=(1,))
    ts = theirs.setup(jax.random.key(0))
    jpop = jnp.asarray(pop.numpy())
    for expect in (True, False):
        with pytest.raises(Exception) as je:
            jax.block_until_ready(theirs.evaluate(ts, jpop))
        assert jdefault_retryable(je.value) is expect and default_retryable(je.value) is expect
        _, ts = theirs.evaluate(ts, jpop)


def test_deadline_penalty_and_trips():
    mine = FaultyProblem(FirstColumn(), delay_generations=(0,), delay_seconds=0.3, eval_deadline=0.05,
                         deadline_penalty=7.0)
    st = mine.setup(torch.tensor([0, 0]))
    fit, st = mine.evaluate(st, torch.from_numpy(_pop(np.random.default_rng(4))))
    assert torch.equal(fit, torch.full_like(fit, 7.0)) and mine.deadline_trips == 1
    mine.reset_faults()
    assert mine.deadline_trips == 0 and mine.attempts("delay", 0) == 0


def test_faulty_problem_pickles_without_its_counters():
    import pickle

    p = FaultyProblem(FirstColumn(), error_generations=(0,))
    p._bump("error", 0)
    q = pickle.loads(pickle.dumps(p))
    assert q.attempts("error", 0) == 0 and q.error_generations == p.error_generations


# ---------------------------------------------------------------------------
# the retry predicate
# ---------------------------------------------------------------------------

REFERENCE_MESSAGES = [
    "UNAVAILABLE: socket closed",
    "INTERNAL: relay died",
    "INTERNAL: CpuCallback error: NONRETRYABLE: crash",
    "DEADLINE_EXCEEDED: probe",
    "ABORTED: x",
    "DATA_LOSS: y",
    "Connection refused",
    "Connection reset by peer",
    "Socket closed",
    "failed to connect to all addresses",
    "plain bug",
    "shape mismatch",
    "CUDA out of memory. Tried to allocate 2.00 GiB",
]

STICKY_CUDA = [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered",
    "CUDA error: CUBLAS_STATUS_INTERNAL_ERROR when calling `cublasSgemm( handle, opa, opb, m, n, k, &alpha, a, lda, b, ldb, &beta, c, ldc)`",
    "CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasGemmEx(...)`",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: misaligned address",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: the launch timed out and was terminated",
]


@pytest.mark.parametrize("msg", REFERENCE_MESSAGES)
@pytest.mark.parametrize("cls", [RuntimeError, ValueError, OSError])
def test_retry_verdicts_equal_the_jax_packages(msg, cls):
    exc = cls(msg)
    assert default_retryable(exc) == jdefault_retryable(exc)


@pytest.mark.parametrize("msg", STICKY_CUDA)
def test_sticky_cuda_errors_are_not_retried_in_process(msg):
    """A sticky CUDA error poisons the CUDA context for the rest of the
    process: never retried here (the JAX predicate would retry the cuBLAS
    one, whose message matches ``INTERNAL``)."""
    for exc in (RuntimeError(msg), torch.cuda.OutOfMemoryError(msg) if "memory" in msg else RuntimeError(msg)):
        assert not default_retryable(exc)
    assert default_retryable(WatchdogTimeout(msg))  # the watchdog keeps its contract


def test_retry_delay_schedule_equals_the_jax_packages():
    for kw in (dict(), dict(backoff_base=0.5, backoff_factor=2.0, backoff_max=3.0), dict(backoff_base=0.01, backoff_factor=1.0)):
        assert [RetryPolicy(**kw).delay(k) for k in range(1, 8)] == [JRetryPolicy(**kw).delay(k) for k in range(1, 8)]


# ---------------------------------------------------------------------------
# the store and the resume scan
# ---------------------------------------------------------------------------


def _states(seed=0):
    g = np.random.default_rng(seed)
    pop = g.standard_normal((16, 6)).astype(np.float32)
    fit = g.standard_normal(16).astype(np.float32)
    port = State(algorithm=State(pop=torch.from_numpy(pop), fit=torch.from_numpy(fit), key=torch.tensor([5, 0])))
    jst = JState(algorithm=JState(pop=jnp.asarray(pop), fit=jnp.asarray(fit), key=jax.random.key(5)))
    return port, jst


def test_faulty_store_fires_the_jax_packages_faults(tmp_path):
    plan = dict(torn_saves=[1], flip_saves=[2], crash_saves=[3], enospc_saves=[4], eio_saves=[5], slow_saves=[0],
                slow_seconds=0.0)
    mine, theirs = FaultyStore(**plan), JFaultyStore(**plan)
    port, jst = _states()
    for i in range(7):
        for store, save, st, d in ((mine, save_state, port, "p"), (theirs, jckpt.save_state, jst, "j")):
            (tmp_path / d).mkdir(exist_ok=True)
            try:
                save(tmp_path / d / f"ckpt_{i:08d}.npz", st, generation=i, store=store)
            except OSError as e:
                assert isinstance(e, (InjectedStorageError, OSError))
    assert mine.events == theirs.events == [(0, "slow"), (1, "torn"), (2, "flip"), (3, "crash"), (4, "enospc"),
                                            (5, "eio")]
    assert mine.saves == theirs.saves == 7
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))


def _damaged_directory(root):
    """Archives of both packages, some damaged: port gens 1-3, JAX gens
    4-6; gen 2 torn, gen 5 with a flipped byte in a leaf, gen 3 without a
    manifest."""
    root.mkdir()
    port, jst = _states()
    for gen in (1, 2):
        save_state(root / f"ckpt_{gen:08d}.npz", port, generation=gen)
    np.savez(root / "ckpt_00000003.npz", x=np.zeros(3))
    for gen in (4, 5, 6):
        jckpt.save_state(root / f"ckpt_{gen:08d}.npz", jst, generation=gen)
    torn = root / "ckpt_00000002.npz"
    torn.write_bytes(torn.read_bytes()[: torn.stat().st_size // 2])
    flip = root / "ckpt_00000005.npz"
    data = bytearray(flip.read_bytes())
    pos = bytes(data).find(np.asarray(jst.algorithm.pop).tobytes()[:16])
    assert pos > 0
    data[pos + 3] ^= 0x01
    flip.write_bytes(bytes(data))
    (root / "stray.npz").write_bytes(b"junk")
    (root / "ckpt_00000001.npz.corrupt").write_bytes(b"old evidence")


@pytest.mark.parametrize("verify", [False, True, "full", "manifest"])
def test_scan_quarantine_decisions_equal_the_jax_packages(tmp_path, verify):
    _damaged_directory(tmp_path / "src")
    shutil.copytree(tmp_path / "src", tmp_path / "p")
    shutil.copytree(tmp_path / "src", tmp_path / "j")
    valid, rejected = scan_checkpoints(tmp_path / "p", verify=verify, quarantine=True)
    jvalid, jrejected = jscan(tmp_path / "j", verify=verify, quarantine=True)
    assert [(g, p.name) for g, p in valid] == [(g, p.name) for g, p in jvalid]
    assert [(p.name, q) for p, _, q in rejected] == [(p.name, q) for p, _, q in jrejected]
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    if verify:
        assert [p.name for p, _, q in rejected if q] == (
            ["ckpt_00000002.npz"] if verify == "manifest" else ["ckpt_00000002.npz", "ckpt_00000005.npz"]
        )
    assert latest_checkpoint(tmp_path / "src", verify=bool(verify)).name == "ckpt_00000006.npz"
    with pytest.raises(ValueError, match="verify must be"):
        scan_checkpoints(tmp_path / "p", verify="deep")
