"""MAC backend registry — the single dispatch point for linear-layer MAC
execution (port of ``repro/core/macexec.py``: the registry, the fp, int8
fake-quant, encoded-MAC QAT and encoded serving executors, and the
speculative drafter's guard).

An executor owns its param-suffix schema (``_s`` position weights,
``_fw``/``_fb`` folded bitplane tensors, ``_as``/``_ws`` activation/weight
scales), init and apply.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.parallel.mesh import (copy_to_model, get_mesh,
                                      reduce_from_model)
from repro_torch.parallel.sharding import linear_role
from repro_torch.quant.uniform import (calibrate_scale, fake_quant,
                                       quantize_codes)

_REGISTRY: dict = {}

# debug-only (``launch/env.py:set_debug_nan``): every linear's output and
# the logits are checked for non-finite values, and the engines run their
# steps eagerly, so the first NaN raises at the op that made it
_DEBUG_NAN = False


def set_debug_nan(flag: bool) -> None:
    """Turn the non-finite check of ``check_finite`` on or off."""
    global _DEBUG_NAN
    _DEBUG_NAN = bool(flag)


def debug_nan_enabled() -> bool:
    return _DEBUG_NAN


def check_finite(out: torch.Tensor, what: str) -> torch.Tensor:
    """With ``set_debug_nan`` on, raise ``FloatingPointError`` naming
    ``what`` when ``out`` holds a NaN or an infinity (one host sync per
    call); off, return ``out`` untouched at no cost."""
    # analysis: allow(host-sync): opt-in set_debug_nan check
    if _DEBUG_NAN and not bool(torch.isfinite(out).all()):
        raise FloatingPointError(f"non-finite value in the output of {what}")
    return out


# Calibration hook: when set, every linear (``nn.common.linear``) and
# dense layer (``core.layers.dense_apply``) reports its call as (name,
# weight, input) before computing.  Installed by the calibration forward
# (repro_torch.serve.encoded) and by checks that read a layer's inputs.
_ACT_RECORDER = None


@contextlib.contextmanager
def activation_recorder(fn):
    """Install ``fn`` as the calibration recorder for the ``with`` body."""
    global _ACT_RECORDER
    prev, _ACT_RECORDER = _ACT_RECORDER, fn
    try:
        yield
    finally:
        _ACT_RECORDER = prev


def record_activation(name: str, w: torch.Tensor, x: torch.Tensor) -> None:
    """Report one linear's call to the installed recorder, if any."""
    if _ACT_RECORDER is not None:
        _ACT_RECORDER(name, w, x)


def register(cls):
    """Class decorator: register a MacExecutor under ``cls.mode``."""
    _REGISTRY[cls.mode] = cls()
    return cls


def get_executor(mode: str) -> "MacExecutor":
    try:
        return _REGISTRY[mode]
    except KeyError:
        raise ValueError(f"unknown MAC mode {mode!r}; registered modes: "
                         f"{sorted(_REGISTRY)}") from None


def count_prepared(params, mode: str) -> int:
    """Number of linears in ``params`` carrying the prepared leaves
    ``mode``'s executor applies with (its first param suffix, e.g. ``_fw``
    for 'encoded_infer').  -1 when the mode needs no prepared leaves."""
    ex = get_executor(mode)
    if not ex.requires_prepared_params or not ex.param_suffixes:
        return -1
    suffix = ex.param_suffixes[0]
    n = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(k, str) and k.endswith(suffix):
                    n += 1
                else:
                    stack.append(v)
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return n


def check_drafter(params, mode: str) -> None:
    """Guard for the speculative-decoding drafter: a prepared-params
    executor handed params with NO prepared leaves would serve the fp
    fallback in every linear, so the "cheap drafter" would be the dense
    model in disguise.  Raise instead."""
    if count_prepared(params, mode) == 0:
        ex = get_executor(mode)
        raise ValueError(
            f"drafter MAC mode {mode!r} requires prepared params "
            f"(no {ex.param_suffixes[0]!r} leaves found) — every linear "
            "would fall back to the fp matmul and the drafter would just "
            "be the dense model; build (draft_params, draft_cfg) with "
            "repro_torch.serve.encoded.prepare_drafter / "
            "prepare_encoded_serving")


def row_sum(out: torch.Tensor, name: str, ways: int) -> torch.Tensor:
    """``out`` of linear ``name``, summed over the model axis where it is
    a row shard's partial product (its k dim cut into ``ways`` > 1); the
    sum's gradient passes to every rank's partial as it is."""
    if ways > 1 and linear_role(name) == "row":
        return reduce_from_model(out)
    return out


def weight_scale(w: torch.Tensor, bits: int, ways: int) -> torch.Tensor:
    """``calibrate_scale`` over the whole weight: with its shards on
    ``ways`` > 1 ranks, over the max of every shard's max-abs, as the
    reference's reduction over a sharded weight computes.  No gradient
    passes through it (``calibrate_scale`` detaches, as the reference's
    ``stop_gradient``)."""
    if ways == 1:
        return calibrate_scale(w, bits)
    amax = get_mesh().all_reduce_max(w.detach().abs().amax().float())
    return calibrate_scale(amax, bits)


def mm(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Matmul in the compute dtype (f32 accumulation; a plain product left
    to PyTorch as the reference leaves it to XLA)."""
    return torch.matmul(x.to(compute_dtype), w.to(compute_dtype))


class MacExecutor:
    """Base executor: fp weight init, no auxiliary leaves."""
    mode: str = "?"
    param_suffixes: tuple = ()
    requires_prepared_params: bool = False

    def init(self, generator: torch.Generator, d_in: int, d_out: int,
             name: str, mcfg, dtype=torch.float32, scale=None) -> dict:
        std = scale if scale is not None else 1.0 / math.sqrt(d_in)
        w = torch.randn((d_in, d_out), generator=generator,
                        dtype=torch.float32) * std
        p = {name: w.to(dtype)}
        p.update(self.aux_init(name, mcfg))
        return p

    def aux_init(self, name: str, mcfg) -> dict:
        """The executor's auxiliary leaves (suffix schema) for one
        linear."""
        return {}

    def apply(self, p: dict, name: str, x: torch.Tensor, mcfg,
              compute_dtype, ways: int = 1) -> torch.Tensor:
        """``x @ p[name]`` under the mode.  ``ways`` > 1: the weight is a
        tensor-parallel shard, one of that many, cut by its role; a row
        shard's partial products are summed over the model axis (before
        the bias of a folded linear)."""
        raise NotImplementedError


@register
class FpExecutor(MacExecutor):
    """Plain fp matmul."""
    mode = "fp"

    def apply(self, p, name, x, mcfg, compute_dtype, ways=1):
        return row_sum(mm(x, p[name], compute_dtype), name, ways)


@register
class Int8Executor(MacExecutor):
    """int8 fake-quant QAT simulation (the paper's "Orig." columns)."""
    mode = "int8"
    param_suffixes = ("_as",)

    def aux_init(self, name, mcfg):
        return {name + "_as": torch.ones((), dtype=torch.float32)}

    def apply(self, p, name, x, mcfg, compute_dtype, ways=1):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        wf = p[name].to(torch.float32)
        sa = p[name + "_as"].detach()
        sw = weight_scale(wf, mcfg.bits, ways)
        out = fake_quant(x2, sa, mcfg.bits) @ fake_quant(wf, sw, mcfg.bits)
        out = row_sum(out, name, ways)
        return out.reshape(*lead, -1).to(compute_dtype)


@register
class EncodedQatExecutor(MacExecutor):
    """Encoded-MAC forward with STE backward + trainable position weights
    (the paper's "Prop." columns; folds the weights on every call, in f32
    outside kernel 1, as the reference does outside its Pallas kernel)."""
    mode = "encoded"
    param_suffixes = ("_s", "_as")

    def aux_init(self, name, mcfg):
        p = {name + "_as": torch.ones((), dtype=torch.float32)}
        if mcfg.per_layer_s:
            p[name + "_s"] = torch.tensor(mcfg.mac.s_init,
                                          dtype=torch.float32)
        return p

    def apply(self, p, name, x, mcfg, compute_dtype, ways=1):
        """Under a mesh (``ways`` > 1) the fold runs on this rank's shard
        at the whole weight's scale (``weight_scale``); a row shard's
        partial encoded products are summed over the model axis, and the
        replicated position weights ``_s``, which reach this rank's
        output only through its shard, get their gradient summed over
        the model axis (``copy_to_model``)."""
        from repro_torch.core.mac import encoded_matmul_qat
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        wf = p[name].to(torch.float32)
        sa = p[name + "_as"].detach()
        sw = weight_scale(wf, mcfg.bits, ways)
        s = p.get(name + "_s")
        if s is None:
            s = torch.as_tensor(mcfg.mac.s_init, dtype=torch.float32,
                                device=x.device)
        elif ways > 1:
            s = copy_to_model(s)
        out = encoded_matmul_qat(x2, wf, sa, sw, s, mcfg.mac.program,
                                 mcfg.bits)
        out = row_sum(out, name, ways)
        return out.reshape(*lead, -1).to(compute_dtype)


@register
class EncodedInferExecutor(MacExecutor):
    """Serving path: weights pre-folded once into bf16 (U, k, n) bitplane
    tensors + f32 bias by ``repro_torch.serve.encoded.
    prepare_encoded_serving``; applies through ``kernels.ops.
    encoded_matmul``.  Linears without folded tensors fall back to the fp
    matmul — the gate is per layer, not global."""
    mode = "encoded_infer"
    param_suffixes = ("_fw", "_fb", "_as", "_ws")
    requires_prepared_params = True

    def init(self, generator, d_in, d_out, name, mcfg, dtype=torch.float32,
             scale=None):
        raise ValueError(
            "'encoded_infer' params are built from fp params by "
            "repro_torch.serve.encoded.prepare_encoded_serving, not "
            "initialized")

    def apply(self, p, name, x, mcfg, compute_dtype, ways=1):
        if name + "_fw" not in p:
            return row_sum(mm(x, p[name], compute_dtype), name, ways)
        from repro_torch.kernels.ops import encoded_matmul
        lead = x.shape[:-1]
        # reference order: f32 input → int8 codes → kernel → × (sa·sw) →
        # compute dtype
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        sa, sw = p[name + "_as"], p[name + "_ws"]
        xc = quantize_codes(x2, sa, mcfg.bits)
        role = linear_role(name) if ways > 1 else "replicated"
        out = encoded_matmul(xc, p[name + "_fw"], p[name + "_fb"],
                             mcfg.mac_for(name).program.a_mono_tuples, role)
        return (out * (sa * sw)).reshape(*lead, -1).to(compute_dtype)
