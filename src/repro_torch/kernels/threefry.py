"""The key chain of the port's random numbers on the card: one hand-written
CUDA kernel, ``threefry_chain_kernel`` in ``csrc/threefry.cu``, that walks
each lane's serial chain of keys for a block of events and draws every
hash word the block needs, for all lanes in one launch.

It replaces no Pallas kernel.  The JAX package draws a block of events by
a scan over ``k_{i+1} = split(k_i)[0]`` and hashes each event's subkeys
``split(k_i)[s]`` and the words drawn from them through XLA's
``threefry2x32`` (``jax.random``); the trainer splits its data key once a
round.  Written in PyTorch on the card, each step of that serial chain is
about a hundred launches, so the chain and the block's words are one
kernel here, and the float conversions of the words (uniforms,
exponentials, normals, bounded integers) stay in PyTorch
(:mod:`repro_torch.core.prng`'s ``*_words`` functions) on every route.

A block's words are named by paths (:func:`paths_tensor`): ``(s, c1, c2,
c3)`` is the subkey ``s`` of the event's key, then the hashes of the
counters ``(0, c1)``, ``(0, c2)``, ``(0, c3)`` in turn, ``-1`` ending the
path.  A scalar draw from a key hashes ``(0, 0)`` and a 2-way split gives
the keys at ``(0, 0)`` and ``(0, 1)``, so every word of JAX's block draws
is one path: the exponential from the event's fourth subkey is ``(3, 0)``,
the hyperexponential's branch and exponential words ``(3, 0, 0)`` and
``(3, 1, 0)``, a bounded integer's two words ``(s, 0, 0)`` and ``(s, 1,
0)``.

:func:`chain_words` launches the kernel for CUDA tensors (or raises) and
runs :func:`chain_words_plain` for CPU tensors only: the chain walked in
Python integers a lane at a time (no PyTorch operation per chain step),
then every path hashed at once by :func:`repro_torch.core.prng.threefry2x32`
on tensors.  ``chain_words.launches`` counts kernel launches.  The kernel
and its plain version are integer functions: the same inputs give the same
words, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import prng
from . import build


def paths_tensor(paths, device) -> torch.Tensor:
    """``[P, 4]`` int32 from paths of one to four entries."""
    rows = [list(p) + [-1] * (4 - len(p)) for p in paths]
    if any(len(r) != 4 or r[0] < 0 for r in rows):
        raise ValueError(f"paths are (s, c1, c2, c3) with s >= 0: {paths}")
    return torch.tensor(rows, dtype=torch.int32,
                        device=device).reshape(len(rows), 4)


def _check(keys, paths):
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be int64 [L, 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if paths.dim() != 2 or paths.shape[1] != 4:
        raise ValueError(f"paths must be [P, 4], got {tuple(paths.shape)}")


def chain_words_plain(keys: torch.Tensor, n: int, paths: torch.Tensor):
    """The kernel's function in Python and PyTorch on ``keys``' device:
    ``(chain [L, n, 2], words [L, n, P, 2])``."""
    _check(keys, paths)
    L, P = keys.shape[0], paths.shape[0]
    dev = keys.device
    host = keys.tolist()
    chain = torch.tensor([prng.chain(k, n) for k in host],
                         dtype=torch.int64).reshape(L, n, 2).to(dev)
    prev = torch.cat([keys[:, None], chain[:, :-1]], dim=1)[:, :n]
    cols = paths.to(device=dev, dtype=torch.int64)
    w = prng.hash_key(prev[:, :, None, :], 0, cols[:, 0])
    for d in range(1, 4):
        c = cols[:, d]
        w = torch.where((c >= 0)[:, None],
                        prng.hash_key(w, 0, c.clamp_min(0)), w)
    return chain, w.reshape(L, n, P, 2)


def _launch(keys, n, paths):
    _check(keys, paths)
    if paths.device != keys.device:
        raise ValueError("threefry chain: keys and paths on different "
                         "devices")
    keys = keys.contiguous()
    paths = paths.to(torch.int32).contiguous()
    L, P = keys.shape[0], paths.shape[0]
    chain = torch.empty((L, n, 2), dtype=torch.int64, device=keys.device)
    words = torch.empty((L, n, P, 2), dtype=torch.int64, device=keys.device)
    fn = build.load("threefry").threefry_chain
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(keys.data_ptr(), paths.data_ptr(), L, int(n), P,
                 chain.data_ptr(), words.data_ptr(), stream)
    build.check(err, "threefry chain launch")
    chain_words.launches += 1
    return chain, words


def chain_words(keys: torch.Tensor, n: int, paths: torch.Tensor):
    """Walk ``n`` steps of each lane's key chain from ``keys [L, 2]`` and
    hash the ``paths [P, 4]`` of every step's key: ``(chain [L, n, 2],
    words [L, n, P, 2])``, ``chain[:, i]`` the key after step ``i`` and
    ``words[:, i, p]`` path ``p`` from the key before it.  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if keys.is_cuda:
        return _launch(keys, n, paths)
    if keys.device.type == "cpu":
        return chain_words_plain(keys, n, paths)
    raise ValueError(f"no threefry chain kernel for device {keys.device}")


chain_words.launches = 0
