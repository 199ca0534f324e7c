"""Build the port's objects from the numpy leaves of the JAX package's.

Each function takes a mapping of field name to numpy array (what
``{k: np.asarray(v) for k, v in obj._asdict().items()}`` gives on the JAX
side; ``None`` for an absent optional field) and returns the port's
``NamedTuple`` on ``device``, floats as ``dtype``; :func:`model_params`
carries a model's weights across, :func:`lm_params_from_jax` and
:func:`lm_cache_from_jax` an LM's weights and decode cache.  The port's
event states carry no PRNG key: :func:`state_key` takes a JAX event
state's ``key`` as the key the port's ``EventStream`` draws from, so a
JAX run resumes in the port mid-way on the same draws.  Nothing here
imports ``jax`` or ``repro``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.buzen import ClassParams, NetworkParams
from .core.complexity import LearningConstants
from .core.energy import PowerProfile
from .core.events import ClassEventState, EventBlocks, EventState
from .core.numerics import DTYPE
from .models.layers import AttnCache


def _tensor(x, device, dtype):
    if x is None:
        return None
    arr = np.array(x)  # a copy: JAX's host views are read-only
    if arr.dtype == np.bool_:
        return torch.as_tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.as_tensor(arr.astype(np.int64), device=device).to(dtype)
    return torch.as_tensor(arr.astype(np.float64), device=device).to(dtype)


def network_params(leaves: Mapping, *, device="cuda",
                   dtype=DTYPE) -> NetworkParams:
    """``NetworkParams`` (``p, mu_c, mu_d, mu_u, mu_cs, n_active``)."""
    f = {k: _tensor(leaves.get(k), device, dtype)
         for k in ("p", "mu_c", "mu_d", "mu_u", "mu_cs")}
    return NetworkParams(**f, n_active=_tensor(leaves.get("n_active"),
                                               device, torch.int64))


def class_params(leaves: Mapping, *, device="cuda",
                 dtype=DTYPE) -> ClassParams:
    """``ClassParams`` (``p, mu_c, mu_d, mu_u, count, mu_cs``); ``count``
    as int64."""
    f = {k: _tensor(leaves.get(k), device, dtype)
         for k in ("p", "mu_c", "mu_d", "mu_u", "mu_cs")}
    return ClassParams(**f, count=_tensor(leaves["count"], device,
                                          torch.int64))


def learning_constants(leaves: Mapping) -> LearningConstants:
    return LearningConstants(**{k: float(v) for k, v in leaves.items()})


def power_profile(leaves: Mapping, *, device="cuda",
                  dtype=DTYPE) -> PowerProfile:
    return PowerProfile(**{k: _tensor(leaves.get(k), device, dtype)
                           for k in ("P_c", "P_u", "P_d", "P_cs")})


_STATE_INT = ("round", "seq_ctr", "client", "cls", "member", "phase", "seq",
              "disp_round", "warmup", "cap", "delay_cnt")


def event_state(leaves: Mapping, *, device="cuda",
                dtype=DTYPE) -> EventState:
    """``EventState`` without its key (:func:`state_key`); integer leaves
    become int32."""
    return _state(EventState, leaves, device, dtype)


def class_event_state(leaves: Mapping, *, device="cuda",
                      dtype=DTYPE) -> ClassEventState:
    """``ClassEventState`` without its key; integer leaves (``cls`` and
    ``member`` among them) become int32."""
    return _state(ClassEventState, leaves, device, dtype)


def state_key(leaves: Mapping, *, device="cuda") -> torch.Tensor:
    """A JAX event state's (or a lane-stacked one's) PRNG ``key``, two
    ``uint32`` words, as the port's ``int64`` key ``[..., 2]``: the key its
    ``EventStream`` continues the JAX state's events from."""
    return torch.as_tensor(np.asarray(leaves["key"]).astype(np.int64),
                           device=device)


def _state(kind, leaves: Mapping, device, dtype):
    out = {}
    for name in kind._fields:
        x = leaves[name]
        if name == "cs_busy":
            out[name] = torch.as_tensor(np.array(x, dtype=bool),
                                        device=device)
        elif name in _STATE_INT:
            out[name] = _tensor(x, device, torch.int32)
        else:
            out[name] = _tensor(x, device, dtype)
    return kind(**out)


def event_blocks(leaves: Mapping, *, device="cuda",
                 dtype=DTYPE) -> EventBlocks:
    """``EventBlocks`` (routed client or class, and member, as int64); a
    JAX block without a CS carries ``svc_cs = ()`` and one of the
    per-client engine ``member = ()``, which become ``None``.

    The uplink and computation leaves are the law's unit parts: the
    hyperexponential's ``(branch, e)`` pair (a tuple, as the JAX law's
    ``unit_draw`` returns it) becomes the port's ``[..., 2]`` leaf.  The
    JAX lognormal stores raw subkeys there; the caller passes the normals
    ``jax.random.normal(k)`` of those keys in their place."""
    def opt(name):
        x = leaves.get(name)
        return None if x is None or np.asarray(x).size == 0 else x

    def unit(x):
        if isinstance(x, (tuple, list)):
            x = np.stack([np.asarray(v) for v in x], axis=-1)
        return _tensor(x, device, dtype)

    return EventBlocks(
        c_new=_tensor(leaves["c_new"], device, torch.int64),
        svc_down=_tensor(leaves["svc_down"], device, dtype),
        up=unit(leaves["up"]),
        comp=unit(leaves["comp"]),
        svc_cs=_tensor(opt("svc_cs"), device, dtype),
        member=_tensor(opt("member"), device, torch.int64))


def model_params(leaves, model: torch.nn.Module) -> dict:
    """The reference's parameter pytree (nested dicts and lists of numpy
    arrays, as ``jax.tree_util.tree_map(np.asarray, params)`` gives) as the
    port module's parameters: ``{name: tensor}`` in ``model``'s own order,
    on its device and in its parameters' types (``model.load_state_dict``
    takes it).

    A dict key is a submodule name and the reference MLP's list of layers
    is the port's ``layers``; conv kernels go from HWIO to OIHW, dense
    ``w [in, out]`` stays as it is (the port's CNN flattens in the
    reference's (H, W, C) order).
    """
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (("layers",) if not prefix else ())
                     + (str(i),))
        else:
            arr = np.array(node, dtype=np.float32)
            flat[".".join(prefix)] = (arr.transpose(3, 2, 0, 1)
                                      if arr.ndim == 4 else arr)

    walk(leaves, ())
    out = {}
    for name, p in model.named_parameters():
        if name not in flat:
            raise ValueError(f"no reference leaf for parameter {name!r}; "
                             f"got {sorted(flat)}")
        arr = flat.pop(name)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {arr.shape}, port "
                             f"shape {tuple(p.shape)}")
        out[name] = torch.as_tensor(np.ascontiguousarray(arr),
                                    device=p.device).to(p.dtype)
    if flat:
        raise ValueError(f"reference leaves with no parameter: "
                         f"{sorted(flat)}")
    return out


def lm_params_from_jax(cfg, params, *, device="cuda") -> dict:
    """The JAX package's LM parameter tree (``init``'s nested dicts and
    lists, numpy or JAX leaves, groups stacked on axis 0) as the port's:
    the same tree of tensors in ``cfg.param_dtype`` on ``device``.  Weights
    keep the ``[in, out]`` layout, so every leaf is a copy, never a
    transpose."""
    dtype = getattr(torch, cfg.param_dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _lm_leaf(node, device, dtype)

    return walk(params)


def _lm_leaf(x, device, dtype) -> torch.Tensor:
    """A float leaf of the JAX package's LM trees as a tensor (a copy)."""
    arr = np.asarray(x)
    if arr.dtype != np.float32:  # bfloat16 leaves come as ml_dtypes
        arr = arr.astype(np.float32)
    return torch.as_tensor(np.array(arr), device=device).to(dtype)


def lm_cache_from_jax(cfg, cache, *, device="cuda") -> dict:
    """The JAX package's LM decode cache (``init_cache``'s or
    ``decode_step``'s tree: ``{"prelude": [...], "groups": {"slot<i>":
    AttnCache(k, v)}}`` with numpy or JAX leaves) as the port's: the same
    tree with the port's ``AttnCache`` of tensors in ``cfg.dtype`` on
    ``device``, which the port's ``decode_step`` takes and updates in
    place."""
    dtype = getattr(torch, cfg.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            if tuple(node._fields) != AttnCache._fields:
                raise ValueError(f"only attention caches are ported, got "
                                 f"{type(node).__name__}{node._fields}")
            return AttnCache(*(_lm_leaf(x, device, dtype) for x in node))
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        raise ValueError(f"unexpected cache leaf {type(node).__name__}")

    return walk(cache)
