"""Encoding search (port of ``repro/core/search.py``; EncodingNet §3.1).

- ``random_search``: the paper's method — sample random circuits, fit
  position weights per sample, keep the min-RMSE circuit, stop once the
  best RMSE is stable;
- ``binary_search_width``: the paper's binary search for the minimum
  output width M whose best sampled RMSE meets a target (Fig 6(a));
- ``anneal``: greedy/annealed local refinement, one gate mutated per
  candidate.

Every draw comes from ``numpy.random.default_rng`` in the reference's
order, and every choice is made on host numpy (``np.argmin`` takes the
first of equal values), so with the same fits the port picks the
reference's circuits.  The fits run on ``device`` (default: the card).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import gates as G
from .circuits import Circuit, circuit_from_batch, sample_circuits
from .encoding import EncodingSpec, fit_position_weights


@dataclasses.dataclass
class SearchResult:
    spec: EncodingSpec
    rmse_trace: np.ndarray        # best-so-far RMSE after each sample
    n_samples: int


def _values_or_default(values, bits_a, bits_b):
    if values is None:
        return G.signed_products(bits_a, bits_b)
    return np.asarray(values, np.float32)


def random_search(seed: int, m_bits: int, n_samples: int = 10_000,
                  bits_a: int = 8, bits_b: int = 8,
                  values: Optional[np.ndarray] = None,
                  batch: int = 64, mixed_only: bool = False,
                  rel_tol: float = 1e-3, patience: int = 2000,
                  row_weights: Optional[np.ndarray] = None,
                  device=None) -> SearchResult:
    """Random circuit sampling with early stop once the best RMSE is
    stable: if it improved by < ``rel_tol`` (relative) over the last
    ``patience`` samples, sampling halts.  ``row_weights`` (T,) makes every
    fit importance-weighted; reported RMSEs are then weighted."""
    rng = np.random.default_rng(seed)
    vals = _values_or_default(values, bits_a, bits_b)

    best_rmse = np.inf
    best = None
    trace = []
    last_improve_at, last_improve_val = 0, np.inf
    done = 0
    while done < n_samples:
        n = min(batch, n_samples - done)
        gt, ii = sample_circuits(rng, n, m_bits, bits_a, bits_b, mixed_only)
        s, rmse = fit_position_weights(gt, ii, vals, bits_a, bits_b,
                                       row_weights=row_weights,
                                       device=device)
        for i in range(n):
            if rmse[i] < best_rmse:
                best_rmse = float(rmse[i])
                best = (circuit_from_batch(gt, ii, i, bits_a, bits_b), s[i])
            trace.append(best_rmse)
        done += n
        if best_rmse < last_improve_val * (1.0 - rel_tol):
            last_improve_val, last_improve_at = best_rmse, done
        elif done - last_improve_at >= patience:
            break
    circ, s = best
    return SearchResult(EncodingSpec(circ, np.asarray(s), best_rmse, vals),
                        np.asarray(trace, np.float32), done)


def anneal(spec: EncodingSpec, seed: int, iters: int = 2000,
           temp0: float = 0.0, batch: int = 64,
           row_weights: Optional[np.ndarray] = None,
           device=None) -> SearchResult:
    """Local refinement: mutate one random gate (type + wiring) per
    candidate, ``batch`` candidates per fit.  ``temp0 == 0`` is greedy
    hill-climbing; ``temp0 > 0`` simulated annealing with linear
    cooling."""
    rng = np.random.default_rng(seed)
    circ = spec.circuit
    bits_a, bits_b = circ.bits_a, circ.bits_b
    vals = spec.values if spec.values is not None else \
        G.signed_products(bits_a, bits_b)
    M, n_in = circ.m_bits, circ.n_inputs

    cur_gt, cur_ii = circ.gate_types.copy(), circ.in_idx.copy()
    cur_rmse = spec.rmse
    best_gt, best_ii, best_rmse, best_s = cur_gt, cur_ii, cur_rmse, spec.s
    trace = [best_rmse]

    done = 0
    while done < iters:
        n = min(batch, iters - done)
        gt = np.repeat(cur_gt[None], n, axis=0)
        ii = np.repeat(cur_ii[None], n, axis=0)
        rows = rng.integers(0, M, size=n)
        gt[np.arange(n), rows] = rng.integers(0, G.N_GATE_TYPES, size=n)
        ii[np.arange(n), rows] = rng.integers(0, n_in, size=(n, 3))
        s, rmse = fit_position_weights(gt, ii, vals, bits_a, bits_b,
                                       row_weights=row_weights,
                                       device=device)
        j = int(np.argmin(rmse))
        t = temp0 * max(0.0, 1.0 - done / max(1, iters))
        # the draw is taken only when t > 0 and the candidate is no better,
        # as in the reference: the generator's stream stays in step
        accept = rmse[j] < cur_rmse or (
            t > 0 and rng.random() < np.exp((cur_rmse - rmse[j]) / t))
        if accept:
            cur_gt, cur_ii, cur_rmse = gt[j], ii[j], float(rmse[j])
            if cur_rmse < best_rmse:
                best_gt, best_ii, best_rmse, best_s = \
                    gt[j], ii[j], float(rmse[j]), s[j]
        done += n
        trace.append(best_rmse)

    out = EncodingSpec(Circuit(best_gt, best_ii, bits_a, bits_b),
                       np.asarray(best_s), best_rmse, vals)
    return SearchResult(out, np.asarray(trace, np.float32), done)


def binary_search_width(seed: int, target_rmse: float,
                        lo: int = 16, hi: int = 128,
                        n_samples: int = 1000,
                        bits_a: int = 8, bits_b: int = 8,
                        values: Optional[np.ndarray] = None,
                        refine: int = 0, device=None
                        ) -> tuple[EncodingSpec, list[dict]]:
    """The paper's binary search for the minimum output width M meeting
    ``target_rmse``: (best spec at the final width, per-iteration
    history).  ``refine > 0`` adds that many anneal steps per width."""
    history = []
    best_at_width: dict[int, SearchResult] = {}
    it = 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        res = random_search(seed + it, mid, n_samples, bits_a, bits_b,
                            values, device=device)
        if refine:
            res = anneal(res.spec, seed + 7919 + it, refine, device=device)
        best_at_width[mid] = res
        history.append({"width": mid, "rmse": res.spec.rmse,
                        "meets_target": res.spec.rmse <= target_rmse})
        if res.spec.rmse > target_rmse:
            lo = mid          # too coarse — need more bits
        else:
            hi = mid          # good — try narrower
        it += 1
    final = best_at_width.get(hi)
    if final is None:
        res = random_search(seed + it, hi, n_samples, bits_a, bits_b, values,
                            device=device)
        if refine:
            res = anneal(res.spec, seed + 7919 + it, refine, device=device)
        final = res
        history.append({"width": hi, "rmse": res.spec.rmse,
                        "meets_target": res.spec.rmse <= target_rmse})
    return final.spec, history


def anneal_choices_apart(spec: EncodingSpec, seed: int, iters: int,
                         fit_a, fit_b, batch: int = 64, temp0: float = 0.0
                         ) -> Optional[tuple[int, float, float]]:
    """Where two fits make ``anneal`` choose differently.

    Replays ``anneal``'s generator stream from ``spec`` along the choices
    of ``fit_a``, fitting every batch of candidates with both ``fit_a``
    and ``fit_b`` (callables (gate_types, in_idx) → rmse (C,)).  Returns
    None if ``fit_b`` makes the same choice at every step, else (step,
    relative spread of the RMSEs involved under ``fit_a``, the same under
    ``fit_b``): the candidates the two picked, and the current circuit
    where they disagree on accepting.  A spread within f32 rounding marks
    a near-tie, not a fault of either fit."""
    rng = np.random.default_rng(seed)
    M, n_in = spec.circuit.m_bits, spec.circuit.n_inputs
    cur_gt, cur_ii = spec.circuit.gate_types, spec.circuit.in_idx
    cur = [spec.rmse, spec.rmse]
    done = 0
    while done < iters:
        n = min(batch, iters - done)
        gt = np.repeat(cur_gt[None], n, axis=0)
        ii = np.repeat(cur_ii[None], n, axis=0)
        rows = rng.integers(0, M, size=n)
        gt[np.arange(n), rows] = rng.integers(0, G.N_GATE_TYPES, size=n)
        ii[np.arange(n), rows] = rng.integers(0, n_in, size=(n, 3))
        r = [np.asarray(fit_a(gt, ii)), np.asarray(fit_b(gt, ii))]
        j = [int(np.argmin(x)) for x in r]
        t = temp0 * max(0.0, 1.0 - done / max(1, iters))
        u = rng.random() if t > 0 and not r[0][j[0]] < cur[0] else None
        acc = [r[i][j[i]] < cur[i] or (
            u is not None and u < np.exp((cur[i] - r[i][j[i]]) / t))
            for i in (0, 1)]
        if (j[0], acc[0]) != (j[1], acc[1]):
            picks = sorted(set(j))

            def spread(i):
                v = [float(r[i][p]) for p in picks]
                if acc[0] != acc[1]:
                    v.append(cur[i])
                return (max(v) - min(v)) / min(v)

            return done, spread(0), spread(1)
        if acc[0]:
            cur_gt, cur_ii = gt[j[0]], ii[j[0]]
            cur = [float(r[0][j[0]]), float(r[1][j[0]])]
        done += n
    return None
