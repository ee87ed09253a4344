"""LinUCB contextual bandit (paper §4.2, eqs. 1-5).

Each frequency is an arm with ridge-regression sufficient statistics
    A_f = I + sum x xᵀ,   b_f = sum r x,   theta_f = A_f⁻¹ b_f
selected by  argmax theta_fᵀx + alpha sqrt(xᵀ A_f⁻¹ x)  during exploration
and argmax theta_fᵀx during exploitation. A⁻¹ is maintained incrementally
(Sherman-Morrison), so a decision is O(|F| d²) — microseconds at d=7.

Storage is structure-of-arrays: the bank holds stacked ``(n_arms, d, d)``
``A``/``A_inv`` and ``(n_arms, d)`` ``b``/``theta`` plus per-arm counters,
kept in ascending-frequency order. Selection rules are einsum-vectorized
over the stack (one numpy dispatch per decision instead of one per arm),
and updates are in-place row operations. The historical dict-of-arms API —
``bank.arms[f].update(...)``, ``arm.n``, ``arm.ucb(x, alpha)`` — survives
as a zero-copy view (:class:`_ArmView`/:class:`_ArmMap`) so the pruning and
refinement frameworks work unchanged.

Arm order is deterministic: always ascending frequency, regardless of
``rebuild``/``remove`` history, so tie-breaks and Thompson's RNG-draw-to-arm
pairing never depend on action-space mutation order.

Actions are opaque sortable keys: 1-D banks key arms by ``float``
frequency; 2-D phase-disaggregated banks (``repro.core.tuner2d``) key them
by ``(f_prefill, f_decode)`` pairs, which sort lexicographically so the
deterministic-order guarantees carry over. The linear model per arm is
unchanged — only band legality branches on the key kind (a pair is legal
when BOTH clocks are in band).

Frequency bands (hierarchical fleet control): ``set_band(f_lo, f_hi)``
restricts *selection* to arms inside ``[f_lo, f_hi]`` via a reversible
boolean mask over the stack — statistics are never destroyed, so a band
that widens on a later FLEET_TICK instantly re-legalizes the arms it had
masked. At least one arm is always legal (the nearest to the band's
midpoint when the band contains none), and with no band set every
selection path is byte-for-byte the unmasked code.
"""
from __future__ import annotations

import bisect
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _key(f):
    """Canonical arm key: ``float`` for 1-D frequency actions,
    ``(float, float)`` for 2-D ``(f_prefill, f_decode)`` actions (see
    ``repro.core.tuner2d``). Pairs sort lexicographically, preserving the
    bank's deterministic ascending-action order; a bank holds one kind of
    key for its whole life (mixing is a caller bug)."""
    if isinstance(f, tuple):
        return (float(f[0]), float(f[1]))
    return float(f)


class LinUCBArm:
    """A standalone single arm (kept for direct use and as the reference
    implementation the vectorized bank is tested against)."""

    def __init__(self, dim: int, ridge: float = 1.0):
        self.dim = dim
        self.A = np.eye(dim) * ridge
        self.A_inv = np.eye(dim) / ridge
        self.b = np.zeros(dim)
        self.theta = np.zeros(dim)
        self.n = 0
        self.reward_sum = 0.0
        self.edp_sum = 0.0

    # ------------------------------------------------------------------
    def update(self, x: np.ndarray, reward: float,
               edp: Optional[float] = None) -> None:
        self.A += np.outer(x, x)
        # Sherman-Morrison rank-1 inverse update
        Ax = self.A_inv @ x
        self.A_inv -= np.outer(Ax, Ax) / (1.0 + x @ Ax)
        self.b += reward * x
        self.theta = self.A_inv @ self.b
        self.n += 1
        self.reward_sum += reward
        if edp is not None:
            self.edp_sum += edp

    # ------------------------------------------------------------------
    @property
    def mean_reward(self) -> float:
        return self.reward_sum / self.n if self.n else 0.0

    @property
    def mean_edp(self) -> float:
        return self.edp_sum / self.n if self.n else float("inf")

    def predict(self, x: np.ndarray) -> float:
        return float(self.theta @ x)

    def ucb(self, x: np.ndarray, alpha: float) -> float:
        bonus = alpha * float(np.sqrt(max(x @ self.A_inv @ x, 0.0)))
        return self.predict(x) + bonus


class _ArmView:
    """Live view of one bank row presenting the ``LinUCBArm`` interface.

    Attribute reads return (writable) slices of the bank's stacked arrays;
    ``update`` delegates to the bank's in-place row update. Views resolve
    their row index on every access, so they stay correct across
    ``remove``/``rebuild`` (and raise ``KeyError`` once the arm is gone).
    """

    __slots__ = ("_bank", "f")

    def __init__(self, bank: "LinUCBBank", f: float):
        self._bank = bank
        self.f = f

    @property
    def _i(self) -> int:
        return self._bank._index[self.f]

    @property
    def dim(self) -> int:
        return self._bank.dim

    @property
    def A(self) -> np.ndarray:
        return self._bank._A[self._i]

    @property
    def A_inv(self) -> np.ndarray:
        return self._bank._A_inv[self._i]

    @property
    def b(self) -> np.ndarray:
        return self._bank._b[self._i]

    @property
    def theta(self) -> np.ndarray:
        return self._bank._theta[self._i]

    @property
    def n(self) -> int:
        return int(self._bank._n[self._i])

    @property
    def reward_sum(self) -> float:
        return float(self._bank._reward_sum[self._i])

    @property
    def edp_sum(self) -> float:
        return float(self._bank._edp_sum[self._i])

    @property
    def mean_reward(self) -> float:
        n = self.n
        return self.reward_sum / n if n else 0.0

    @property
    def mean_edp(self) -> float:
        n = self.n
        return self.edp_sum / n if n else float("inf")

    def update(self, x: np.ndarray, reward: float,
               edp: Optional[float] = None) -> None:
        self._bank.update_arm(self.f, x, reward, edp)

    def predict(self, x: np.ndarray) -> float:
        return float(self.theta @ x)

    def ucb(self, x: np.ndarray, alpha: float) -> float:
        bonus = alpha * float(np.sqrt(max(x @ self.A_inv @ x, 0.0)))
        return self.predict(x) + bonus

    def __repr__(self) -> str:
        return f"_ArmView(f={self.f}, n={self.n})"


class _ArmMap(Mapping):
    """Read-only mapping ``frequency -> _ArmView`` over the bank, iterating
    in ascending-frequency order. Mutation goes through the bank
    (``remove``/``rebuild``), never through this map."""

    __slots__ = ("_bank",)

    def __init__(self, bank: "LinUCBBank"):
        self._bank = bank

    def __getitem__(self, f) -> _ArmView:
        f = _key(f)
        if f not in self._bank._index:
            raise KeyError(f)
        return _ArmView(self._bank, f)

    def __iter__(self) -> Iterator[float]:
        return iter(self._bank._f)

    def __len__(self) -> int:
        return len(self._bank._f)

    def __contains__(self, f) -> bool:           # avoid Mapping's try/except
        return _key(f) in self._bank._index


class LinUCBBank:
    """The arm set over the current (mutable) frequency action space.

    Selection strategies (beyond-paper extension):
      * "linucb"   — the paper's UCB rule (eq. 1/2)
      * "thompson" — linear Thompson sampling: per arm, sample
        theta ~ N(theta_f, nu^2 A_f^-1) and pick argmax x' theta_sample.
        Randomized exploration composes better with non-stationary reward
        drift (no deterministic untried-arm sweeps); compared empirically
        in benchmarks/ext_thompson.py.
    """

    def __init__(self, frequencies: Sequence[float], dim: int,
                 ridge: float = 1.0, seed: int = 0):
        self.dim = dim
        self.ridge = ridge
        self.rng = np.random.default_rng(seed)
        self.arms = _ArmMap(self)
        self._band: Optional[Tuple[float, float]] = None
        self._legal: Optional[np.ndarray] = None   # bool mask; None = all
        self._alloc(sorted({_key(f) for f in frequencies}))

    # -- storage -------------------------------------------------------
    def _alloc(self, freqs: List[float]) -> None:
        n, d = len(freqs), self.dim
        self._f: List[float] = freqs              # ascending, deduplicated
        #: pair-keyed (2-D action) banks branch only in band legality;
        #: every selection/update path is key-agnostic
        self._pair = bool(freqs) and isinstance(freqs[0], tuple)
        self._index: Dict[float, int] = {f: i for i, f in enumerate(freqs)}
        eye = np.eye(d)
        self._A = np.broadcast_to(eye * self.ridge, (n, d, d)).copy()
        self._A_inv = np.broadcast_to(eye / self.ridge, (n, d, d)).copy()
        self._b = np.zeros((n, d))
        self._theta = np.zeros((n, d))
        self._n = np.zeros(n, dtype=np.int64)
        self._reward_sum = np.zeros(n)
        self._edp_sum = np.zeros(n)
        self._apply_band()

    def _drop_rows(self, keep: np.ndarray) -> None:
        self._f = [f for f, k in zip(self._f, keep) if k]
        self._index = {f: i for i, f in enumerate(self._f)}
        self._A = self._A[keep]
        self._A_inv = self._A_inv[keep]
        self._b = self._b[keep]
        self._theta = self._theta[keep]
        self._n = self._n[keep]
        self._reward_sum = self._reward_sum[keep]
        self._edp_sum = self._edp_sum[keep]
        self._apply_band()

    # -- frequency band (hierarchical fleet control) -------------------
    @property
    def band(self) -> Optional[Tuple[float, float]]:
        return self._band

    def set_band(self, f_lo: float, f_hi: float) -> None:
        """Restrict selection to arms inside ``[f_lo, f_hi]`` (inclusive,
        inverted bounds tolerated). Reversible — statistics survive; the
        mask is recomputed on every action-space mutation."""
        lo, hi = (float(f_lo), float(f_hi))
        if lo > hi:
            lo, hi = hi, lo
        self._band = (lo, hi)
        self._apply_band()

    def clear_band(self) -> None:
        self._band = None
        self._legal = None

    def _apply_band(self) -> None:
        """Recompute the legal-arm mask; a band that contains no arm (e.g.
        narrower than the grid step) legalizes the single arm nearest to
        its midpoint so the bandit always has an action."""
        if self._band is None:
            self._legal = None
            return
        lo, hi = self._band
        f = np.asarray(self._f)
        if self._pair:
            # 2-D actions: the band intersects BOTH axes — a pair is legal
            # only when prefill AND decode clocks lie inside [lo, hi], so
            # hierarchy/thermal clamps compose with phase disaggregation.
            # Empty-band fallback: the pair nearest (Euclidean) to the
            # midpoint corner (mid, mid).
            legal = ((f >= lo - 1e-9) & (f <= hi + 1e-9)).all(axis=1)
            if not legal.any() and len(f):
                mid = (lo + hi) / 2.0
                d2 = ((f - mid) ** 2).sum(axis=1)
                legal[int(np.argmin(d2))] = True
            self._legal = legal
            return
        legal = (f >= lo - 1e-9) & (f <= hi + 1e-9)
        if not legal.any() and len(f):
            legal[int(np.argmin(np.abs(f - (lo + hi) / 2.0)))] = True
        self._legal = legal

    def is_legal(self, f: float) -> bool:
        return (self._legal is None
                or bool(self._legal[self._index[_key(f)]]))

    def n_legal(self) -> int:
        return (len(self._f) if self._legal is None
                else int(self._legal.sum()))

    def legal_frequencies(self) -> List[float]:
        if self._legal is None:
            return list(self._f)
        return [f for f, ok in zip(self._f, self._legal) if ok]

    def _argmax_legal(self, scores: np.ndarray) -> float:
        """Highest-scoring legal arm; ties break to the lowest frequency
        (subsetting preserves ascending order)."""
        if self._legal is None:
            return self._f[int(np.argmax(scores))]
        idx = np.flatnonzero(self._legal)
        return self._f[int(idx[int(np.argmax(scores[idx]))])]

    # ------------------------------------------------------------------
    @property
    def frequencies(self) -> List[float]:
        return list(self._f)

    def arm_stats(self) -> List[Tuple[float, int, float, float]]:
        """``(f, n, mean_reward, mean_edp)`` per arm in ascending-frequency
        order, computed in one vectorized pass — the bulk-read interface
        the pruning framework walks (identical values to reading each
        ``arms[f]`` view: same elementwise divisions, same zero/inf
        conventions for unsampled arms)."""
        n = self._n
        safe = np.where(n > 0, n, 1)
        mr = np.where(n > 0, self._reward_sum / safe, 0.0)
        me = np.where(n > 0, self._edp_sum / safe, np.inf)
        return list(zip(self._f, n.tolist(), mr.tolist(), me.tolist()))

    def remove(self, f: float) -> None:
        i = self._index.get(_key(f))
        if i is None:
            return
        keep = np.ones(len(self._f), dtype=bool)
        keep[i] = False
        self._drop_rows(keep)

    def rebuild(self, frequencies: Sequence[float],
                warm_from: Optional[float] = None) -> None:
        """Refinement: re-center the action space. Arms for surviving
        frequencies keep their statistics; NEW arms are warm-started from
        the anchor arm's sufficient statistics (nearby frequencies behave
        similarly — a sane prior that avoids re-exploring a fresh grid from
        scratch after every refinement)."""
        old_index, old = self._index, (self._A, self._A_inv, self._b,
                                       self._theta, self._n,
                                       self._reward_sum, self._edp_sum)
        proto = old_index.get(_key(warm_from)) if warm_from is not None \
            else None
        if proto is not None and old[4][proto] == 0:
            proto = None                          # untouched anchor: no prior
        self._alloc(sorted({_key(f) for f in frequencies}))
        for f, i in self._index.items():
            src = old_index.get(f, proto)
            if src is None:
                continue
            self._A[i] = old[0][src]
            self._A_inv[i] = old[1][src]
            self._b[i] = old[2][src]
            self._theta[i] = old[3][src]
            self._n[i] = old[4][src]
            self._reward_sum[i] = old[5][src]
            self._edp_sum[i] = old[6][src]

    # -- updates -------------------------------------------------------
    def update_arm(self, f: float, x: np.ndarray, reward: float,
                   edp: Optional[float] = None) -> None:
        """Sherman-Morrison rank-1 update of one arm, in place on the
        stacked arrays (arithmetic-identical to ``LinUCBArm.update``)."""
        i = self._index[_key(f)]
        self._A[i] += np.outer(x, x)
        A_inv = self._A_inv[i]
        Ax = A_inv @ x
        A_inv -= np.outer(Ax, Ax) / (1.0 + x @ Ax)
        b = self._b[i]
        b += reward * x
        self._theta[i] = A_inv @ b
        self._n[i] += 1
        self._reward_sum[i] += reward
        if edp is not None:
            self._edp_sum[i] += edp

    def update_arms(self, fs: Sequence[float], xs: np.ndarray,
                    rewards: Sequence[float],
                    edps: Optional[Sequence[float]] = None) -> None:
        """Batched Sherman-Morrison: credit one observation to each of
        several DISTINCT arms in a single einsum pass. No in-tree policy
        batches credits yet (the tuner settles one window at a time via
        ``update_arm``); this is the vectorized-bank API for controllers
        that do, kept numerically equivalent by the hot-path tests."""
        idx = np.array([self._index[_key(f)] for f in fs])
        if len(set(idx.tolist())) != len(idx):
            raise ValueError("update_arms requires distinct arms; "
                             "sequential rank-1 updates to one arm do not "
                             "commute with batching")
        X = np.asarray(xs, dtype=float).reshape(len(idx), self.dim)
        r = np.asarray(rewards, dtype=float)
        self._A[idx] += np.einsum("bi,bj->bij", X, X)
        Ax = np.einsum("bij,bj->bi", self._A_inv[idx], X)
        denom = 1.0 + np.einsum("bi,bi->b", X, Ax)
        self._A_inv[idx] -= np.einsum("bi,bj->bij", Ax, Ax) \
            / denom[:, None, None]
        self._b[idx] += r[:, None] * X
        self._theta[idx] = np.einsum("bij,bj->bi", self._A_inv[idx],
                                     self._b[idx])
        self._n[idx] += 1
        self._reward_sum[idx] += r
        if edps is not None:
            self._edp_sum[idx] += np.asarray(edps, dtype=float)

    # -- selection (vectorized over the stack) -------------------------
    def _scores_ucb(self, x: np.ndarray, alpha: float) -> np.ndarray:
        quad = np.einsum("i,aij,j->a", x, self._A_inv, x)
        return self._theta @ x + alpha * np.sqrt(np.maximum(quad, 0.0))

    def select_ucb(self, x: np.ndarray, alpha: float) -> float:
        # untried arms first (infinite-bonus convention), lowest-f first so
        # exploration sweeps upward through the cheap range
        untried = self._n == 0
        if self._legal is not None:
            untried = untried & self._legal
        if untried.any():
            return self._f[int(np.argmax(untried))]
        return self.argmax_ucb(x, alpha)

    def argmax_ucb(self, x: np.ndarray, alpha: float) -> float:
        """Highest-UCB arm, ignoring the untried-arm convention (used by
        predictive refinement to pick its anchor). Ties break to the lowest
        frequency."""
        return self._argmax_legal(self._scores_ucb(x, alpha))

    def select_thompson(self, x: np.ndarray, nu: float = 0.3) -> float:
        """Linear Thompson sampling over the arm set: one batched Cholesky
        of the (symmetrized) covariances, one (n_arms, d) normal draw."""
        n, d = len(self._f), self.dim
        sym = (self._A_inv + np.swapaxes(self._A_inv, 1, 2)) / 2.0 \
            + 1e-12 * np.eye(d)
        try:
            L = np.linalg.cholesky(sym)
        except np.linalg.LinAlgError:
            L = np.empty_like(sym)                # salvage the healthy arms
            for i in range(n):
                try:
                    L[i] = np.linalg.cholesky(sym[i])
                except np.linalg.LinAlgError:
                    L[i] = np.eye(d)
        z = self.rng.standard_normal((n, d))
        theta_s = self._theta + nu * np.einsum("aij,aj->ai", L, z)
        return self._argmax_legal(theta_s @ x)

    def select_greedy(self, x: np.ndarray) -> float:
        return self._argmax_legal(self._theta @ x)

    def best_historical(self, min_samples: int = 1) -> Optional[float]:
        mask = self._n >= min_samples
        if self._legal is not None:
            mask = mask & self._legal
        if not mask.any():
            return None
        mean_edp = np.full(len(self._f), np.inf)
        np.divide(self._edp_sum, self._n, out=mean_edp, where=mask)
        return self._f[int(np.argmin(mean_edp))]


# ---------------------------------------------------------------------------
# Stacked banks: one more SoA level — (n_nodes, n_slots, ...) — so a fleet of
# per-node LinUCB banks selects and updates in single numpy dispatches.
# ---------------------------------------------------------------------------

class _StackedArmView:
    """``LinUCBArm``-compatible view of one (node, frequency) row of a
    :class:`StackedBanks` — resolved live, like :class:`_ArmView`."""

    __slots__ = ("_banks", "_node", "f")

    def __init__(self, banks: "StackedBanks", node: int, f: float):
        self._banks = banks
        self._node = node
        self.f = f

    @property
    def _s(self) -> int:
        s = self._banks.slot_of(self._node, self.f)
        if s < 0:
            raise KeyError(self.f)
        return s

    @property
    def n(self) -> int:
        return int(self._banks.n_[self._node, self._s])

    @property
    def reward_sum(self) -> float:
        return float(self._banks.reward_sum[self._node, self._s])

    @property
    def edp_sum(self) -> float:
        return float(self._banks.edp_sum[self._node, self._s])

    @property
    def mean_reward(self) -> float:
        n = self.n
        return self.reward_sum / n if n else 0.0

    @property
    def mean_edp(self) -> float:
        n = self.n
        return self.edp_sum / n if n else float("inf")


class _StackedArmMap(Mapping):
    """Read-only ``frequency -> _StackedArmView`` mapping for one node of a
    :class:`StackedBanks` (ascending-frequency iteration order) — the
    interface :class:`repro.core.pruning.PruningFramework` walks."""

    __slots__ = ("_banks", "_node")

    def __init__(self, banks: "StackedBanks", node: int):
        self._banks = banks
        self._node = node

    def __getitem__(self, f) -> _StackedArmView:
        f = float(f)
        if self._banks.slot_of(self._node, f) < 0:
            raise KeyError(f)
        return _StackedArmView(self._banks, self._node, f)

    def __iter__(self) -> Iterator[float]:
        return iter(self._banks.node_frequencies(self._node))

    def __len__(self) -> int:
        return int(self._banks.m[self._node])

    def __contains__(self, f) -> bool:
        return self._banks.slot_of(self._node, float(f)) >= 0


class StackedBankView:
    """``LinUCBBank``-compatible facade over ONE node of a
    :class:`StackedBanks` — the adapter through which the unchanged
    per-node pruning/refinement frameworks mutate the stack. Every method
    reproduces the corresponding ``LinUCBBank`` arithmetic on this node's
    row slices (same expressions, same numpy calls on the same logical
    shapes), so a framework acting through the view is bit-identical to
    one acting on a standalone bank."""

    __slots__ = ("_banks", "_node", "arms", "band")

    def __init__(self, banks: "StackedBanks", node: int):
        self._banks = banks
        self._node = node
        self.arms = _StackedArmMap(banks, node)
        self.band = None                      # stacked path: no fleet bands

    @property
    def frequencies(self) -> List[float]:
        return self._banks.node_frequencies(self._node)

    def is_legal(self, f: float) -> bool:
        return True

    def n_legal(self) -> int:
        return int(self._banks.m[self._node])

    def remove(self, f: float) -> None:
        self._banks.remove(self._node, f)

    def rebuild(self, frequencies: Sequence[float],
                warm_from: Optional[float] = None) -> None:
        self._banks.rebuild(self._node, frequencies, warm_from)

    def best_historical(self, min_samples: int = 1) -> Optional[float]:
        return self._banks.best_historical(self._node, min_samples)

    def argmax_ucb(self, x: np.ndarray, alpha: float) -> float:
        return self._banks.argmax_ucb(self._node, x, alpha)

    def arm_stats(self) -> List[Tuple[float, int, float, float]]:
        """Bulk ``(f, n, mean_reward, mean_edp)`` read — see
        ``LinUCBBank.arm_stats``; row slices of this node's stack."""
        b, i = self._banks, self._node
        m = int(b.m[i])
        n = b.n_[i, :m]
        safe = np.where(n > 0, n, 1)
        mr = np.where(n > 0, b.reward_sum[i, :m] / safe, 0.0)
        me = np.where(n > 0, b.edp_sum[i, :m] / safe, np.inf)
        return list(zip(b._freq_list(i), n.tolist(), mr.tolist(),
                        me.tolist()))


class StackedBanks:
    """A fleet of per-node LinUCB banks stored as one more SoA level:
    ``(n_nodes, capacity, ...)`` stacks with per-node active-slot counts.

    Invariants per node ``i``: slots ``[0, m[i])`` hold the live arms in
    ascending-frequency order (matching ``LinUCBBank._f``); dead slots keep
    pristine ridge statistics (finite values, so batched selection over the
    full ``capacity`` axis stays NaN-free and is masked afterwards).

    Batched operations use only ops verified bit-identical to the scalar
    bank's: ``einsum('ki,kj->kij')`` for outers, batched ``matmul`` for
    gemv/dot (NOT ``einsum('ki,ki->k')``, whose reduction order differs
    from BLAS ddot), and the quad form ``einsum('ki,kaij,kj->ka')``.
    Per-node mutation (``remove``/``rebuild``, driven by the unchanged
    pruning/refinement frameworks through :class:`StackedBankView`) edits
    row slices in place.
    """

    def __init__(self, n_nodes: int, frequencies: Sequence[float], dim: int,
                 ridge: float = 1.0, capacity: Optional[int] = None):
        freqs = sorted({float(f) for f in frequencies})
        self.n_nodes = n_nodes
        self.dim = dim
        self.ridge = ridge
        K = capacity or max(len(freqs) + 4, 24)
        if K < len(freqs):
            raise ValueError(f"capacity {K} < initial arms {len(freqs)}")
        self.capacity = K
        d = dim
        self._eye_A = np.eye(d) * ridge
        self._eye_Ainv = np.eye(d) / ridge
        self.freqs = np.full((n_nodes, K), np.inf)
        self.freqs[:, :len(freqs)] = freqs
        self.m = np.full(n_nodes, len(freqs), dtype=np.int64)
        self.A = np.broadcast_to(self._eye_A, (n_nodes, K, d, d)).copy()
        self.A_inv = np.broadcast_to(self._eye_Ainv, (n_nodes, K, d, d)).copy()
        self.b = np.zeros((n_nodes, K, d))
        self.theta = np.zeros((n_nodes, K, d))
        self.n_ = np.zeros((n_nodes, K), dtype=np.int64)
        self.reward_sum = np.zeros((n_nodes, K))
        self.edp_sum = np.zeros((n_nodes, K))
        # per-node active-frequency lists, memoised for the scalar
        # adapters (pruning walks resolve slots thousands of times per
        # mutation); invalidated by _reset_slot/remove/rebuild
        self._flist: Dict[int, List[float]] = {}

    # -- per-node introspection ----------------------------------------
    def _freq_list(self, i: int) -> List[float]:
        fl = self._flist.get(i)
        if fl is None:
            fl = self.freqs[i, :self.m[i]].tolist()
            self._flist[i] = fl
        return fl

    def node_frequencies(self, i: int) -> List[float]:
        return list(self._freq_list(i))

    def slot_of(self, i: int, f: float) -> int:
        """Active slot holding frequency ``f`` on node ``i``; -1 if absent."""
        row = self._freq_list(i)
        s = bisect.bisect_left(row, f)
        if s < len(row) and row[s] == f:
            return s
        return -1

    def view(self, i: int) -> StackedBankView:
        return StackedBankView(self, i)

    # -- vectorized slot resolution ------------------------------------
    def slots_for(self, idx: np.ndarray, fs: np.ndarray) -> np.ndarray:
        """For each (node, frequency) pair: its active slot, or -1 when the
        frequency is no longer in that node's action space (pruned or
        dropped by a rebuild — the ``bank.arms.get(...) is None`` case)."""
        rows = self.freqs[idx]                              # (k, K)
        slots = np.sum(rows < fs[:, None], axis=1)
        k = len(idx)
        hit = np.zeros(k, dtype=bool)
        in_range = slots < self.capacity
        safe = np.where(in_range, slots, 0)
        hit = in_range & (rows[np.arange(k), safe] == fs) \
            & (safe < self.m[idx])
        return np.where(hit, safe, -1)

    # -- batched update (Sherman-Morrison) -----------------------------
    def update_rows(self, nodes: np.ndarray, slots: np.ndarray,
                    X: np.ndarray, rewards: np.ndarray,
                    edps: np.ndarray) -> None:
        """Credit one observation to one arm per node, all nodes at once.
        Arithmetic-identical to ``LinUCBBank.update_arm`` row by row."""
        sel = (nodes, slots)
        self.A[sel] += np.einsum("ki,kj->kij", X, X)
        Ainv = self.A_inv[sel]
        Ax = np.matmul(Ainv, X[:, :, None])[:, :, 0]
        denom = 1.0 + np.matmul(X[:, None, :], Ax[:, :, None])[:, 0, 0]
        Ainv -= np.einsum("ki,kj->kij", Ax, Ax) / denom[:, None, None]
        self.A_inv[sel] = Ainv
        bsel = self.b[sel]
        bsel += rewards[:, None] * X
        self.b[sel] = bsel
        self.theta[sel] = np.matmul(Ainv, bsel[:, :, None])[:, :, 0]
        self.n_[sel] += 1
        self.reward_sum[sel] += rewards
        self.edp_sum[sel] += edps

    # -- batched selection ---------------------------------------------
    def select_batch(self, idx: np.ndarray, X: np.ndarray, alpha: float,
                     greedy: np.ndarray):
        """Per-node arm choice: ``select_greedy`` where ``greedy`` is set,
        ``select_ucb`` (untried-first, then UCB argmax) elsewhere. Returns
        ``(slots, freqs)``. First-max argmax over ascending active slots
        reproduces the scalar banks' lowest-frequency tie-break."""
        K = self.capacity
        valid = np.arange(K)[None, :] < self.m[idx][:, None]
        theta = self.theta[idx]
        tx = np.matmul(theta, X[:, :, None])[:, :, 0]
        ng = ~greedy
        if ng.any():
            # the exploration bonus (the quad form — the dominant cost)
            # is only consulted on non-greedy rows; each row's einsum
            # contraction is independent of its batch neighbours, so the
            # subset dispatch is bit-identical to the full one
            sub = idx[ng]
            Xs = X[ng]
            quad = np.einsum("ki,kaij,kj->ka", Xs, self.A_inv[sub], Xs)
            scores = tx.copy()
            scores[ng] = tx[ng] + alpha * np.sqrt(np.maximum(quad, 0.0))
        else:
            scores = tx
        scores = np.where(valid, scores, -np.inf)
        slot = np.argmax(scores, axis=1)
        if ng.any():
            untried = valid[ng] & (self.n_[idx[ng]] == 0)
            has_u = untried.any(axis=1)
            if has_u.any():
                sl = slot[ng]
                slot[ng] = np.where(has_u, np.argmax(untried, axis=1), sl)
        return slot, self.freqs[idx, slot]

    # -- per-node mutation (pruning / refinement path) -----------------
    def _reset_slot(self, i: int, s: int) -> None:
        self._flist.pop(i, None)
        self.freqs[i, s] = np.inf
        self.A[i, s] = self._eye_A
        self.A_inv[i, s] = self._eye_Ainv
        self.b[i, s] = 0.0
        self.theta[i, s] = 0.0
        self.n_[i, s] = 0
        self.reward_sum[i, s] = 0.0
        self.edp_sum[i, s] = 0.0

    def _reset_node(self, i: int) -> None:
        """Broadcast reset of every slot of node ``i`` — one array write
        per stack instead of ``capacity`` scalar ``_reset_slot`` calls."""
        self._flist.pop(i, None)
        self.freqs[i] = np.inf
        self.A[i] = self._eye_A
        self.A_inv[i] = self._eye_Ainv
        self.b[i] = 0.0
        self.theta[i] = 0.0
        self.n_[i] = 0
        self.reward_sum[i] = 0.0
        self.edp_sum[i] = 0.0

    def remove(self, i: int, f: float) -> None:
        s = self.slot_of(i, float(f))
        if s < 0:
            return
        m = int(self.m[i])
        for arr in (self.freqs, self.n_, self.reward_sum, self.edp_sum,
                    self.A, self.A_inv, self.b, self.theta):
            arr[i, s:m - 1] = arr[i, s + 1:m]
        self.m[i] = m - 1
        self._reset_slot(i, m - 1)

    def rebuild(self, i: int, frequencies: Sequence[float],
                warm_from: Optional[float] = None) -> None:
        """Per-node ``LinUCBBank.rebuild``: surviving frequencies keep their
        rows, new frequencies warm-start from the anchor (skipped when the
        anchor was never sampled)."""
        new = sorted({float(f) for f in frequencies})
        if len(new) > self.capacity:
            raise ValueError(f"rebuild wants {len(new)} arms, "
                             f"capacity {self.capacity}")
        m = int(self.m[i])
        old_f = [float(f) for f in self.freqs[i, :m]]
        if new == old_f:
            # identity rebuild: every arm survives with its own row and
            # dead slots are already pristine (class invariant) — the
            # state after the full copy-out/reset/copy-back dance equals
            # the state before it, so skip the dance. A converged fleet
            # re-anchors on the same grid most refinement rounds, making
            # this the common case at day scale.
            return
        old_index = {f: s for s, f in enumerate(old_f)}
        old = (self.A[i, :m].copy(), self.A_inv[i, :m].copy(),
               self.b[i, :m].copy(), self.theta[i, :m].copy(),
               self.n_[i, :m].copy(), self.reward_sum[i, :m].copy(),
               self.edp_sum[i, :m].copy())
        proto = old_index.get(float(warm_from)) if warm_from is not None \
            else None
        if proto is not None and old[4][proto] == 0:
            proto = None                      # untouched anchor: no prior
        self._reset_node(i)
        self.freqs[i, :len(new)] = new
        self.m[i] = len(new)
        for s, f in enumerate(new):
            src = old_index.get(f, proto)
            if src is None:
                continue
            self.A[i, s] = old[0][src]
            self.A_inv[i, s] = old[1][src]
            self.b[i, s] = old[2][src]
            self.theta[i, s] = old[3][src]
            self.n_[i, s] = old[4][src]
            self.reward_sum[i, s] = old[5][src]
            self.edp_sum[i, s] = old[6][src]

    # -- per-node selection helpers (refinement anchors) ---------------
    def best_historical(self, i: int, min_samples: int = 1
                        ) -> Optional[float]:
        m = int(self.m[i])
        mask = self.n_[i, :m] >= min_samples
        if not mask.any():
            return None
        mean_edp = np.full(m, np.inf)
        np.divide(self.edp_sum[i, :m], self.n_[i, :m], out=mean_edp,
                  where=mask)
        return float(self.freqs[i, int(np.argmin(mean_edp))])

    def argmax_ucb(self, i: int, x: np.ndarray, alpha: float) -> float:
        m = int(self.m[i])
        quad = np.einsum("i,aij,j->a", x, self.A_inv[i, :m], x)
        scores = self.theta[i, :m] @ x \
            + alpha * np.sqrt(np.maximum(quad, 0.0))
        return float(self.freqs[i, int(np.argmax(scores))])

    def argmax_ucb_batch(self, idx: np.ndarray, X: np.ndarray,
                         alpha: float) -> np.ndarray:
        """One UCB-argmax anchor per node in ``idx`` — the batched form of
        :meth:`argmax_ucb`, using the same verified-identical batched gemv
        and quad-form dispatches as :meth:`select_batch` (dead slots carry
        pristine finite statistics and are masked to -inf, and first-max
        argmax over ascending slots keeps the lowest-frequency
        tie-break)."""
        K = self.capacity
        valid = np.arange(K)[None, :] < self.m[idx][:, None]
        tx = np.matmul(self.theta[idx], X[:, :, None])[:, :, 0]
        quad = np.einsum("ki,kaij,kj->ka", X, self.A_inv[idx], X)
        scores = tx + alpha * np.sqrt(np.maximum(quad, 0.0))
        scores = np.where(valid, scores, -np.inf)
        return self.freqs[idx, np.argmax(scores, axis=1)]
