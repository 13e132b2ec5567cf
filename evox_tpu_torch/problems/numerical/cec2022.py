"""CEC 2022 single-objective test suite, 12 functions in D ∈ {2, 10, 20}
(counterpart of ``evox_tpu/problems/numerical/cec2022.py``).

The same declarative layout as the JAX package: the 15 basic functions are
module-level ``(n, d) -> (n,)`` tensor expressions, and the hybrid (F6-F8)
and composition (F9-F12) functions are spec tables read by two generic
functions.  Shift vectors, rotation matrices and shuffle indices come from
the official competition data files, read in place from the JAX package's
``cec2022_input_data/`` directory (by a path built from this file's; the
port imports nothing of that package).  They are loaded on the host at
construction and held on the problem's device; an evaluation reads no
value back.

Every rotation is a full-precision product, never TF32: the JAX package
asks for ``precision="highest"``, and the port takes each product in
float64 and rounds it to the problem's dtype (:func:`_rotate`), so neither
the process-wide matmul setting nor a change to it is involved.

Function numbers, transforms and biases follow the official suite: F1
Zakharov (+300), F2 Rosenbrock (+400), F3 Schaffer F7 (+600), F4
Rastrigin (+800), F5 Levy (+900), F6-F8 hybrids (+1800/2000/2200), F9-F12
compositions (+2300/2400/2600/2700).
"""

from __future__ import annotations

import math
import os
from math import ceil

import numpy as np
import torch

from ... import resolve_device
from ...core import Problem, State

__all__ = ["CEC2022"]

# The JAX package's data files, read in place: evox_tpu_torch/problems/
# numerical -> the checkout's root -> evox_tpu/problems/numerical.
_DATA_DIR = os.path.normpath(
    os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "..", "..", "..", "evox_tpu", "problems", "numerical", "cec2022_input_data",
    )
)


# ---------------------------------------------------------------------------
# Basic functions: (n, d) -> (n,) tensor expressions, written as the JAX
# package writes them (squares and fourth powers as products, as XLA's
# integer powers are).
# ---------------------------------------------------------------------------


def _arange1(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(1, x.shape[1] + 1, dtype=x.dtype, device=x.device)


def _zakharov(x):
    s2 = torch.sum(0.5 * _arange1(x) * x, dim=1)
    s2sq = s2 * s2
    return torch.sum(x * x, dim=1) + s2sq + s2sq * s2sq


def _rosenbrock(x):
    y = x + 1
    a = y[:, :-1] * y[:, :-1] - y[:, 1:]
    b = y[:, :-1] - 1.0
    return torch.sum(100.0 * (a * a) + b * b, dim=1)


def _schaffer_f7(x):
    s = torch.hypot(x[:, :-1], x[:, 1:])
    t = torch.sin(50.0 * s**0.2)
    f = torch.mean(torch.sqrt(s) * (1 + t * t), dim=1)
    return f * f


def _rastrigin(x):
    return torch.sum(x * x - 10.0 * torch.cos(2.0 * math.pi * x) + 10.0, dim=1)


def _levy(x):
    w = 1.0 + x / 4.0
    s0 = torch.sin(math.pi * w[:, 0])
    t1 = s0 * s0
    wl = w[:, -1] - 1
    sl = torch.sin(2 * math.pi * w[:, -1])
    t2 = wl * wl * (1 + sl * sl)
    wm = w[:, :-1] - 1
    sm = torch.sin(math.pi * w[:, :-1] + 1)
    mid = wm * wm * (1 + 10 * (sm * sm))
    return t1 + torch.sum(mid, dim=1) + t2


def _bent_cigar(x):
    return x[:, 0] * x[:, 0] + torch.sum(1e6 * (x[:, 1:] * x[:, 1:]), dim=1)


def _hgbat(x):
    t = x - 1
    r2 = torch.sum(t * t, dim=1)
    sx = torch.sum(t, dim=1)
    return torch.abs(r2 * r2 - sx * sx) ** 0.5 + (0.5 * r2 + sx) / x.shape[1] + 0.5


def _katsuura(x):
    d = x.shape[1]
    pow2 = 2.0 ** torch.arange(1, 33, dtype=x.dtype, device=x.device)
    t = x[:, :, None] * pow2[None, None, :]  # (n, d, 32)
    frac = torch.sum(torch.abs(t - torch.floor(t + 0.5)) / pow2, dim=2)
    f = torch.prod((1 + frac * _arange1(x)[None, :]) ** (10.0 / d**1.2), dim=1)
    return (f - 1) * (10.0 / d / d)


def _ackley(x):
    m1 = torch.mean(x * x, dim=1)
    m2 = torch.mean(torch.cos(2.0 * math.pi * x), dim=1)
    return math.e - 20.0 * torch.exp(-0.2 * torch.sqrt(m1)) - torch.exp(m2) + 20.0


def _schwefel(x):
    d = x.shape[1]
    z = x + 420.9687462275036
    az = torch.abs(z)
    inner = -z * torch.sin(torch.sqrt(az))
    rem = 500.0 - torch.fmod(az, 500)
    wrapped = rem * torch.sin(torch.sqrt(torch.abs(rem)))
    above, below = z - 500.0, z + 500.0
    out = torch.where(z > 500.0, -wrapped + above * above / 10000.0 / d, inner)
    out = torch.where(z < -500.0, wrapped + below * below / 10000.0 / d, out)
    return torch.sum(out, dim=1) + 418.98288727243378 * d


def _escaffer6(x):
    y = torch.roll(x, -1, dims=1)
    s = x * x + y * y
    st = torch.sin(torch.sqrt(s))
    den = 1.0 + 0.001 * s
    return torch.sum(0.5 + (st * st - 0.5) / (den * den), dim=1)


def _happycat(x):
    d = x.shape[1]
    t = x - 1
    r2 = torch.sum(t * t, dim=1)
    sx = torch.sum(t, dim=1)
    return torch.abs(r2 - d) ** 0.25 + (0.5 * r2 + sx) / d + 0.5


def _grie_rosen(x):
    y = x + 1
    z = torch.roll(y, -1, dims=1)
    a = y * y - z
    b = y - 1.0
    t = 100.0 * (a * a) + b * b
    return torch.sum(t * t / 4000.0 - torch.cos(t) + 1.0, dim=1)


def _griewank(x):
    idx = _arange1(x)
    return 1.0 + torch.sum(x * x, dim=1) / 4000.0 - torch.prod(torch.cos(x / torch.sqrt(idx)), dim=1)


def _discus(x):
    return 1e6 * (x[:, 0] * x[:, 0]) + torch.sum(x[:, 1:] * x[:, 1:], dim=1)


def _ellips(x):
    d = x.shape[1]
    powers = 6.0 * torch.arange(d, dtype=x.dtype, device=x.device) / (d - 1)
    return torch.sum(10.0**powers * (x * x), dim=1)


# ---------------------------------------------------------------------------
# Suite specification tables (the JAX package's, entry for entry).
# ---------------------------------------------------------------------------

# F1-F5: (basic function, shrink rate, bias).
_SIMPLE = {
    1: (_zakharov, 1.0, 300.0),
    2: (_rosenbrock, 2.048e-2, 400.0),
    3: (_schaffer_f7, 1.0, 600.0),
    4: (_rastrigin, 5.12e-2, 800.0),  # NC-Rastrigin == Rastrigin in the suite
    5: (_levy, 1.0, 900.0),
}

# F6-F8: (segment fractions, [(fn, shrink rate)...], bias).
_HYBRID = {
    6: ([0.4, 0.4, 0.2], [(_bent_cigar, 1.0), (_hgbat, 5.0e-2), (_rastrigin, 5.12e-2)], 1800.0),
    7: (
        [0.1, 0.2, 0.2, 0.2, 0.1, 0.2],
        [
            (_hgbat, 5.0e-2),
            (_katsuura, 5.0e-2),
            (_ackley, 1.0),
            (_rastrigin, 5.12e-2),
            (_schwefel, 10.0),
            (_schaffer_f7, 1.0),
        ],
        2000.0,
    ),
    8: (
        [0.3, 0.2, 0.2, 0.1, 0.2],
        [
            (_katsuura, 5.0e-2),
            (_happycat, 5.0e-2),
            (_grie_rosen, 5.0e-2),
            (_schwefel, 10.0),
            (_ackley, 1.0),
        ],
        2200.0,
    ),
}

# F9-F12: (sigmas, biases, [(fn, shrink rate, rotate?, scale)...], bias).
_COMPOSITION = {
    9: (
        [10, 20, 30, 40, 50],
        [0, 200, 300, 100, 400],
        [
            (_rosenbrock, 2.048e-2, True, 1.0),
            (_ellips, 1.0, True, 1e4 / 1e10),
            (_bent_cigar, 1.0, True, 1e4 / 1e10 / 1e10 / 1e10),
            (_discus, 1.0, True, 1e4 / 1e10),
            (_ellips, 1.0, False, 1e4 / 1e10),
        ],
        2300.0,
    ),
    10: (
        [20, 10, 10],
        [0, 200, 100],
        [
            (_schwefel, 10.0, False, 1.0),
            (_rastrigin, 5.12e-2, True, 1.0),
            (_hgbat, 5.0e-2, True, 1.0),
        ],
        2400.0,
    ),
    11: (
        [20, 20, 30, 30, 20],
        [0, 200, 300, 400, 200],
        [
            (_escaffer6, 1.0, True, 1e4 / 2e7),
            (_schwefel, 10.0, True, 1.0),
            (_griewank, 6.0, True, 1e3 / 1e2),
            (_rosenbrock, 2.048e-2, True, 1.0),
            (_rastrigin, 5.12e-2, True, 1e4 / 1e3),
        ],
        2600.0,
    ),
    12: (
        [10, 20, 30, 40, 50, 60],
        [0, 300, 500, 100, 400, 200],
        [
            (_hgbat, 5.0e-2, True, 1e4 / 1e3),
            (_rastrigin, 5.12e-2, True, 1e4 / 1e3),
            (_schwefel, 10.0, True, 1e4 / 4e3),
            (_bent_cigar, 1.0, True, 1e4 / 1e10 / 1e10 / 1e10),
            (_ellips, 1.0, True, 1e4 / 1e10),
            (_escaffer6, 1.0, True, 1e4 / 2e7),
        ],
        2700.0,
    ),
}


def _rotate(z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``z @ m`` at full precision (``precision="highest"`` in the JAX
    package): the product is taken in float64 and rounded to ``z``'s
    dtype, so no process-wide matmul setting (TF32) reaches it and none is
    touched."""
    return torch.matmul(z.to(torch.float64), m.to(torch.float64)).to(z.dtype)


def _load(name: str, dtype=None) -> np.ndarray:
    path = os.path.join(_DATA_DIR, name)
    if not os.path.isdir(_DATA_DIR):
        raise FileNotFoundError(
            f"CEC2022: the suite's data directory {_DATA_DIR} is missing; the "
            "port reads the official data files in place from the evox_tpu "
            "package of the same checkout"
        )
    return np.loadtxt(path) if dtype is None else np.loadtxt(path, dtype=dtype)


class CEC2022(Problem):
    """One function of the CEC2022 suite, selected by ``problem_number``
    (1-12) and ``dimension`` (2, 10 or 20).  Search domain: [-100, 100]^d.

    :param problem_number: suite function index, 1-12.
    :param dimension: 2, 10 or 20 (functions 6-8 are undefined for D=2, as
        in the official suite).
    :param dtype: the evaluation dtype (float32; float64 for the oracle).
    :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
        CPU.
    """

    def __init__(self, problem_number: int, dimension: int, dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None):
        if dimension not in (2, 10, 20):
            raise ValueError(f"Test functions are only defined for D=2,10,20, got {dimension}.")
        if not 1 <= problem_number <= 12:
            raise ValueError(f"Function {problem_number} is not defined.")
        if problem_number in (6, 7, 8) and dimension == 2:
            raise ValueError(f"Function {problem_number} is not defined for D=2.")
        self.device = resolve_device(device)
        self.nx = dimension
        self.func_num = problem_number
        self.dtype = dtype

        d = dimension
        m_data = _load(f"M_{problem_number}_D{d}.txt")
        if problem_number < 9:
            m = m_data.reshape(d, d).T  # (d, d): rotate as x @ M
        else:
            m = m_data.reshape(-1, d).T  # (d, cf_num * d)
        self.M = torch.as_tensor(np.ascontiguousarray(m), dtype=dtype, device=self.device)
        self._M64 = self.M.to(torch.float64)  # the rotations' operand (``_rotate``)

        shift = _load(f"shift_data_{problem_number}.txt")
        if problem_number < 9:
            shift = np.ravel(shift)[:d]
        else:
            shift = shift.reshape(10, -1)[:9, :d].reshape(-1)
        self.shift = torch.as_tensor(np.ascontiguousarray(shift), dtype=dtype, device=self.device)

        if 6 <= problem_number <= 8:
            ss = _load(f"shuffle_data_{problem_number}_D{d}.txt", dtype=np.int64)
            self.SS = torch.as_tensor(ss[:d] - 1, device=self.device)  # to 0-based
        else:
            self.SS = None

    @property
    def lb(self) -> torch.Tensor:
        """Decision-space lower bound (the CEC2022 domain is [-100, 100]^d)."""
        return torch.full((self.nx,), -100.0, dtype=self.dtype, device=self.device)

    @property
    def ub(self) -> torch.Tensor:
        """Decision-space upper bound (the CEC2022 domain is [-100, 100]^d)."""
        return torch.full((self.nx,), 100.0, dtype=self.dtype, device=self.device)

    # -- transforms ---------------------------------------------------------
    @staticmethod
    def _sr(x, rate: float, rotate: bool, shift, m):
        """Shift-and-rotate with shrink rate (the reference's
        ``sr_func_rate``).  A rate of 1 is skipped: the product is exact."""
        z = x - shift
        if rate != 1.0:
            z = z * rate
        return _rotate(z, m) if rotate else z

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, state: State, pop: torch.Tensor) -> tuple[torch.Tensor, State]:
        if pop.ndim != 2 or pop.shape[1] != self.nx:
            raise ValueError(f"Dimension mismatch! Expect {self.nx}, got {tuple(pop.shape)}.")
        x = pop.to(self.dtype)
        n = self.func_num
        if n in _SIMPLE:
            fn, rate, bias = _SIMPLE[n]
            fit = fn(self._sr(x, rate, True, self.shift, self._M64)) + bias
        elif n in _HYBRID:
            fit = self._hybrid(x, *_HYBRID[n])
        else:
            fit = self._composition(x, *_COMPOSITION[n])
        return fit, state

    def _hybrid(self, x, fractions, parts, bias):
        """Shift → rotate → shuffle → split into segments, one basic
        function per segment (the reference's ``cut`` + ``cec2022_f6..f8``)."""
        d = self.nx
        sizes = [ceil(g * d) for g in fractions]
        sizes[-1] = d - sum(sizes[:-1])
        z = self._sr(x, 1.0, True, self.shift, self._M64)
        z = z[:, self.SS]
        total, off = 0.0, 0
        for (fn, rate), size in zip(parts, sizes):
            total = total + fn(z[:, off : off + size] * rate)
            off += size
        return total + bias

    def _composition(self, x, sigmas, biases, parts, f_bias):
        """Distance-weighted blend of shifted, rotated components (the
        reference's ``cf_cal`` + ``cec2022_f9..f12``)."""
        d = self.nx
        comp_fits, weights, exacts = [], [], []
        tiny = torch.finfo(x.dtype).tiny
        for i, ((fn, rate, rotate, scale), sigma, b) in enumerate(zip(parts, sigmas, biases)):
            shift_i = self.shift[i * d : (i + 1) * d]
            m_i = self._M64[:, i * d : (i + 1) * d]
            comp_fits.append(fn(self._sr(x, rate, rotate, shift_i, m_i)) * scale + b)
            diff = x - shift_i
            diff2 = torch.sum(diff * diff, dim=1)
            exacts.append(diff2 == 0)
            weights.append(
                torch.exp(-diff2 / (2 * d * sigma * sigma)) / torch.sqrt(torch.clamp(diff2, min=tiny))
            )
        w = torch.stack(weights)  # (cf_num, n)
        f = torch.stack(comp_fits)
        exact = torch.stack(exacts)
        # A point exactly on a component's shift selects that component (the
        # first such, as argmax gives it): a one-hot weight, the finite limit
        # of the reference's infinite weight (which gives inf/inf = NaN).
        first = torch.argmax(exact.to(torch.uint8), dim=0)
        onehot = torch.arange(len(parts), device=x.device)[:, None] == first[None, :]
        w = torch.where(exact.any(dim=0)[None, :], onehot.to(w.dtype), w)
        w_sum = torch.sum(w, dim=0)
        w_sum = torch.where(w_sum == 0, torch.full((), 1e-9, dtype=w.dtype, device=w.device), w_sum)
        return torch.sum(w * f, dim=0) / w_sum + f_bias
