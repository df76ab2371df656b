"""Mid-march checkpoint and resume for the transient marches.

PyTorch counterpart of the march half of
``hybrid_fem_lssvr_tpu/utils/checkpoint.py`` (``march_fingerprint``,
``_write_march``, ``load_march_state``, ``chunked_scan``,
``scan_checkpointed``), with the same on-disk format, so a march state
written by either package has one layout:

* ``march_manifest.json`` — ``{"fingerprint", "step", "n_carry",
  "ys_files", "format": "march-v2"}``, written last, and here also
  ``"ys_tuple"``, whether a step's outputs are a tuple (the JAX package
  ignores the key);
* ``march.npz`` — the carry leaves ``carry_0 .. carry_{n-1}`` after the
  manifest's step;
* ``ys_XXXXXX.npz`` — one immutable file a chunk with that chunk's slice
  of the per-step outputs (``ys_0 ..``), append-only, so a march of S
  steps writes each output row once (O(S) IO).

Each write goes through a temporary file and ``os.replace`` in the order
ys slice, carry, manifest, so a crash at any point leaves a prefix that
resumes.  A ys file that no manifest names is an orphan of such a crash
and is overwritten on the next run.

JAX's ``lax.scan`` is ``scan`` here: a Python loop over the time axis
that calls the same step function on ``ts[i]`` (a 0-d tensor, so the
loop reads nothing back to the host for t).  Chunking calls the same
function on the same values in the same order, so a chunked, a resumed
and a plain march give bit-for-bit the same result (JAX's jitted chunk
and its eager scan are different programs and may differ by an ulp).

The carry is a tensor or a flat tuple (or NamedTuple) of tensors; a
step's output is None, a tensor or Python number, or a flat tuple of
them.  Leaves are written with ``.cpu().numpy()`` and restored as tensors
on the device and in the dtype of the live carry.  Stacked outputs lie on
the device of the carry's first leaf (Python numbers are stacked there
too), whether they were computed, restored or both, and keep their tuple
structure through the manifest's ``ys_tuple``; a state the JAX package
wrote has no such key, and its outputs come back as a tuple when there
is more than one leaf.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings

import numpy as np
import torch


def march_fingerprint(problem_name: str, cfg, tcfg, march: str) -> str:
    """Fingerprint of everything that determines the march trajectory.
    The checkpoint fields themselves (path, chunk size) are excluded:
    resuming with a different chunking is legal and bit-for-bit equal."""
    td = dataclasses.asdict(tcfg)
    td.pop("checkpoint", None)
    td.pop("checkpoint_chunk", None)
    payload = json.dumps(
        {"problem": problem_name, "march": march,
         "cfg": dataclasses.asdict(cfg), "tcfg": td},
        sort_keys=True, default=str,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _ys_filename(idx: int) -> str:
    """Single source of the per-chunk ys filename (writer and loader)."""
    return f"ys_{idx:06d}.npz"


def _host(v):
    """A leaf as a numpy array (device tensors copied to the host)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _write_march(path: str, fingerprint: str, step: int, leaves,
                 ys_chunk_leaves, ys_files, *, ys_tuple=False) -> None:
    """One chunk's durable state: the new ys slice (its own immutable
    file), then the carry, then the manifest, in that order, each atomic,
    so a crash at any point leaves a resumable prefix.  Appends the new
    ys file's name to ``ys_files``; ``ys_tuple`` (the outputs are a
    tuple) goes into the manifest."""
    os.makedirs(path, exist_ok=True)
    if ys_chunk_leaves is not None:
        fname = _ys_filename(len(ys_files))
        ys_tmp = os.path.join(path, f".{fname}.tmp")
        with open(ys_tmp, "wb") as fh:
            np.savez(fh, **{f"ys_{i}": _host(v)
                            for i, v in enumerate(ys_chunk_leaves)})
        os.replace(ys_tmp, os.path.join(path, fname))
        ys_files.append(fname)
    arrays = {f"carry_{i}": _host(v) for i, v in enumerate(leaves)}
    npz_tmp = os.path.join(path, ".march.npz.tmp")
    with open(npz_tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(npz_tmp, os.path.join(path, "march.npz"))
    manifest = {
        "fingerprint": fingerprint,
        "step": int(step),
        "n_carry": len(leaves),
        "ys_files": list(ys_files),
        "format": "march-v2",
        "ys_tuple": bool(ys_tuple),
    }
    man_tmp = os.path.join(path, ".march_manifest.json.tmp")
    with open(man_tmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
    os.replace(man_tmp, os.path.join(path, "march_manifest.json"))


def load_march_state(path: str, fingerprint: str):
    """(step, carry_leaves, ys_leaves, ys_files) as numpy arrays, or None
    (missing, fingerprint mismatch, other format).  ``ys_leaves`` is the
    per-leaf concatenation of every completed chunk file; ``ys_files``
    their names (a resume appends to them)."""
    state = _load_state(path, fingerprint)
    return None if state is None else state[:4]


def _load_state(path: str, fingerprint: str):
    """``load_march_state``'s tuple and the manifest's ``ys_tuple`` (None
    where the manifest has no such key), or None."""
    mpath = os.path.join(path, "march_manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as fh:
        manifest = json.load(fh)
    if manifest.get("fingerprint") != fingerprint:
        return None
    if manifest.get("format") != "march-v2":
        return None
    with np.load(os.path.join(path, "march.npz")) as z:
        carry = [z[f"carry_{i}"] for i in range(manifest["n_carry"])]
    ys_files = list(manifest.get("ys_files", []))
    # A listed but missing ys file means an asynchronous writer's name
    # raced its write (the JAX package's AsyncCheckpointer schedules the
    # name first): the state is invalid, so restart from step 0.
    if any(not os.path.exists(os.path.join(path, f)) for f in ys_files):
        warnings.warn(
            f"march checkpoint at {path!r} lists ys files that were "
            "never durably written; ignoring the state and restarting "
            "from step 0", stacklevel=2)
        return None
    per_chunk = []
    for fname in ys_files:
        with np.load(os.path.join(path, fname)) as z:
            per_chunk.append([z[f"ys_{i}"] for i in range(len(z.files))])
    ys = []
    if per_chunk:
        for k in range(len(per_chunk[0])):
            ys.append(np.concatenate([c[k] for c in per_chunk], axis=0))
    return (manifest["step"], carry, ys, ys_files,
            manifest.get("ys_tuple"))


def _leaves(tree):
    """The leaves of a carry or a step output: a flat tuple's entries,
    else the value itself."""
    if isinstance(tree, tuple):
        return list(tree)
    return [tree]


def _rebuild(like, leaves):
    """A carry of ``like``'s structure from ``leaves``."""
    if not isinstance(like, tuple):
        return leaves[0]
    if hasattr(like, "_fields"):  # NamedTuple
        return type(like)(*leaves)
    return tuple(leaves)


def _stack(vals, device):
    """Per-step values of one output leaf stacked along a new step axis:
    tensors with ``torch.stack`` on their device, Python numbers as a
    tensor on ``device``."""
    if isinstance(vals[0], torch.Tensor):
        return torch.stack(vals)
    return torch.tensor(vals, device=device)


def _device(carry):
    """The device of the carry's first leaf (None, the CPU, for a Python
    number)."""
    return getattr(_leaves(carry)[0], "device", None)


def scan(step_fn, carry, ts):
    """``jax.lax.scan(step_fn, carry, ts)`` as a Python loop: ``step_fn
    (carry, t) -> (carry, y)`` on each ``ts[i]``; returns the last carry
    and the stacked outputs (None when the steps output None)."""
    device = _device(carry)
    ys = []
    for i in range(int(ts.shape[0])):
        carry, y = step_fn(carry, ts[i])
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    if isinstance(ys[0], tuple):
        return carry, tuple(_stack([y[k] for y in ys], device)
                            for k in range(len(ys[0])))
    return carry, _stack(ys, device)


def chunked_scan(scan_chunk_fn, carry0, ts, *, path=None, chunk=0,
                 fingerprint="", checkpointer=None):
    """Host-chunked scan with resumable checkpointing.

    ``scan_chunk_fn(carry, ts_slice) -> (carry, ys_slice)`` scans one
    slice of the time axis.  With ``path=None`` this is one call on the
    whole axis.  Otherwise the axis is cut into ``chunk``-step chunks
    (default ~8 chunks); after each chunk the (next step index, carry, new
    ys slice) is written atomically and append-only, and a matching
    on-disk state resumes from its step index: completed chunks are never
    recomputed and never rewritten.

    ``carry0`` may be a zero-argument callable only without ``path``: a
    resume must not run it, and its structure cannot be recovered here
    without running it.  ``checkpointer`` (the JAX package's thread-
    offloaded writer) is not ported: a non-None value raises."""
    if checkpointer is not None:
        raise NotImplementedError(
            "chunked_scan(checkpointer=...): AsyncCheckpointer is not "
            "ported; pass checkpointer=None for synchronous writes")
    n = int(ts.shape[0])
    if not path:
        return scan_chunk_fn(carry0() if callable(carry0) else carry0, ts)
    if callable(carry0):
        raise NotImplementedError(
            "chunked_scan: a callable carry0 cannot be checkpointed (its "
            "structure is not known without running it); pass the carry")
    chunk = int(chunk) if chunk else max(1, -(-n // 8))
    start, carry = 0, carry0
    ys_chunks = []  # live chunks' output leaves, each [k, ...]
    tuple_ys = None
    ys_files = []
    restored_ys = []
    state = _load_state(path, fingerprint)
    if state is not None and 0 < state[0] <= n:
        start = state[0]
        live = _leaves(carry0)
        if len(state[1]) != len(live):
            raise ValueError(
                f"march checkpoint at {path!r} holds {len(state[1])} carry "
                f"leaves; the march carries {len(live)}")
        carry = _rebuild(carry0, [
            torch.as_tensor(x).to(device=v.device, dtype=v.dtype)
            for x, v in zip(state[1], live)])
        restored_ys = state[2]
        ys_files = state[3]
        tuple_ys = state[4]

    i = start
    while i < n:
        j = min(i + chunk, n)
        carry, ys_c = scan_chunk_fn(carry, ts[i:j])
        ys_leaves_c = None
        if ys_c is not None:
            tuple_ys = isinstance(ys_c, tuple)
            ys_leaves_c = _leaves(ys_c)
            ys_chunks.append(ys_leaves_c)
        _write_march(path, fingerprint, j, _leaves(carry), ys_leaves_c,
                     ys_files, ys_tuple=bool(tuple_ys))
        i = j
    ys_all = _concat_ys(restored_ys, ys_chunks, _device(carry))
    if not ys_all:
        return carry, None
    if tuple_ys or (tuple_ys is None and len(ys_all) > 1):
        return carry, tuple(ys_all)
    return carry, ys_all[0]


def scan_checkpointed(step_fn, carry0, ts, *, path=None, chunk=0,
                      fingerprint="", checkpointer=None):
    """``scan(step_fn, carry0, ts)`` with chunked checkpointing.

    With ``path=None`` this is one ``scan``.  Otherwise ``chunked_scan``
    cuts the time axis, writes (step, carry, ys slice) atomically per
    chunk (ys append-only, O(S) total IO) and resumes a matching on-disk
    state from its step index; resumed and uninterrupted runs are bit for
    bit identical to the plain scan (the same step calls in the same
    order)."""
    return chunked_scan(lambda c, t: scan(step_fn, c, t), carry0, ts,
                        path=path, chunk=chunk, fingerprint=fingerprint,
                        checkpointer=checkpointer)


def _concat_ys(restored_ys, ys_chunks, device):
    """Per-leaf concatenation of the restored prefix and the live chunks'
    outputs along the step axis, as tensors ([] when the march emits no
    outputs).  The result lies on the live chunks' device, or on
    ``device`` when every chunk was restored."""
    if not ys_chunks:
        return [torch.as_tensor(v).to(device) for v in restored_ys]
    out = []
    for k in range(len(ys_chunks[0])):
        parts = [c[k] for c in ys_chunks]
        if len(restored_ys):
            parts.insert(0, torch.as_tensor(restored_ys[k]).to(
                device=parts[0].device, dtype=parts[0].dtype))
        out.append(torch.cat(parts))
    return out
