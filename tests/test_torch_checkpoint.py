"""The port's mid-march checkpoint (``utils/checkpoint.py``) and the
checkpointed marches, on the CPU in float64.

The reference's properties (``tests/test_transient.py``'s checkpoint
tests): a march killed after its second chunk's write resumes to the
uninterrupted result bit for bit, a fingerprint mismatch does not resume,
every output row is written exactly once into append-only files, and the
adaptive march resumes at attempt 32.  On the port the checkpointed and
resumed runs are also bit for bit the plain (unchunked) run: both call
the same step function on the same values in the same order.  The on-disk
format is the JAX package's: each package reads the other's state.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from hybrid_fem_lssvr_tpu.utils import checkpoint as JCK

from hybrid_fem_lssvr_tpu_torch import Solver2DConfig, SolverConfig
from hybrid_fem_lssvr_tpu_torch.models import transient as TR
from hybrid_fem_lssvr_tpu_torch.utils import checkpoint as CK

torch.set_num_threads(1)
CPU = dict(device="cpu")


class Killed(Exception):
    """The simulated kill."""


@pytest.fixture
def kill_after_second_write(monkeypatch):
    """Make the second chunk write raise after it is durable."""
    orig = CK._write_march
    calls = {"n": 0}

    def bomb(*a, **k):
        orig(*a, **k)
        calls["n"] += 1
        if calls["n"] == 2:
            raise Killed

    monkeypatch.setattr(CK, "_write_march", bomb)
    yield lambda: monkeypatch.setattr(CK, "_write_march", orig)


def _step(c, t):
    c2 = c * (1.0 + 0.01 * t) + torch.sin(t + c[0])
    return c2, torch.sum(c2)


TS = torch.linspace(0.0, 1.0, 24, dtype=torch.float64)
C0 = torch.arange(5, dtype=torch.float64)


def test_scan_checkpointed_kill_and_resume(tmp_path,
                                           kill_after_second_write):
    ref_c, ref_y = CK.scan(_step, C0, TS)
    path = str(tmp_path / "m")
    with pytest.raises(Killed):
        CK.scan_checkpointed(_step, C0, TS, path=path, chunk=6,
                             fingerprint="fp")
    kill_after_second_write()  # restore the writer
    st = CK.load_march_state(path, "fp")
    assert st[0] == 12  # two 6-step chunks durable
    c, y = CK.scan_checkpointed(_step, C0, TS, path=path, chunk=6,
                                fingerprint="fp")
    assert torch.equal(c, ref_c) and torch.equal(y, ref_y)
    # a fingerprint mismatch must not resume
    assert CK.load_march_state(path, "other") is None
    # resuming a finished march is a pure load; another chunking is legal
    c2, y2 = CK.scan_checkpointed(_step, C0, TS, path=path, chunk=5,
                                  fingerprint="fp")
    assert torch.equal(c2, ref_c) and torch.equal(y2.to(ref_y), ref_y)


def test_resume_with_another_chunking(tmp_path, kill_after_second_write):
    path = str(tmp_path / "m")
    with pytest.raises(Killed):
        CK.scan_checkpointed(_step, C0, TS, path=path, chunk=5,
                             fingerprint="fp")
    kill_after_second_write()
    c, y = CK.scan_checkpointed(_step, C0, TS, path=path, chunk=7,
                                fingerprint="fp")
    ref_c, ref_y = CK.scan(_step, C0, TS)
    assert torch.equal(c, ref_c) and torch.equal(y, ref_y)


def test_scan_checkpointed_io_is_linear(tmp_path, monkeypatch):
    """Every step's output row is written exactly once, and the chunk
    files are immutable: no filename is written twice."""
    S, chunk = 24, 6
    rows = {"written": 0}
    files = []
    orig = CK._write_march

    def counting(path, fp, step_i, leaves, ys_chunk_leaves, ys_files,
                 **kw):
        if ys_chunk_leaves is not None:
            rows["written"] += int(ys_chunk_leaves[0].shape[0])
            files.append(CK._ys_filename(len(ys_files)))
        orig(path, fp, step_i, leaves, ys_chunk_leaves, ys_files, **kw)

    monkeypatch.setattr(CK, "_write_march", counting)

    def step(c, t):
        c2 = c + t
        return c2, c2

    ts = torch.linspace(0.0, 1.0, S, dtype=torch.float64)
    c0 = torch.zeros(3, dtype=torch.float64)
    c, y = CK.scan_checkpointed(step, c0, ts, path=str(tmp_path / "io"),
                                chunk=chunk, fingerprint="fp")
    assert rows["written"] == S
    assert len(files) == S // chunk
    assert len(set(files)) == len(files)
    refc, refy = CK.scan(step, c0, ts)
    assert torch.equal(y, refy) and torch.equal(c, refc)


@pytest.mark.parametrize("kind", ["tensor", "number", "one_leaf_tuple",
                                  "pair"])
def test_fully_resumed_outputs_keep_their_structure(tmp_path, kind):
    """A march whose every chunk is on disk returns its per-step outputs
    as a live run does: the same structure (a one-leaf tuple stays a
    tuple), values, dtype and device (the carry's)."""
    def step(c, t):
        c2, y = _step(c, t)
        return c2, {"tensor": y, "number": int(c2.numel()),
                    "one_leaf_tuple": (y,), "pair": (y, 2 * c2)}[kind]

    ref_c, ref_y = CK.scan(step, C0, TS)
    path = str(tmp_path / kind)
    outs = [CK.scan_checkpointed(step, C0, TS, path=path, chunk=6,
                                 fingerprint="fp") for _ in range(2)]
    assert CK.load_march_state(path, "fp")[0] == TS.shape[0]
    for c, y in outs:  # uninterrupted, then every chunk restored
        assert torch.equal(c, ref_c)
        assert isinstance(y, tuple) == isinstance(ref_y, tuple)
        for a, b in zip(CK._leaves(y), CK._leaves(ref_y)):
            assert torch.equal(a, b) and a.dtype == b.dtype
            assert a.device == b.device == c.device


def test_hybrid_march_checkpoint_bitwise(tmp_path, kill_after_second_write):
    p = TR.heat_1d()
    cfg = SolverConfig(num_nodes=33, M=8, dtype="float64")
    base = TR.TransientConfig(t_final=0.25, n_steps=32)
    ref = TR.hybrid_march(p, cfg, base, **CPU)
    t1 = dataclasses.replace(base, checkpoint=str(tmp_path / "hm"),
                             checkpoint_chunk=8)
    with pytest.raises(Killed):
        TR.hybrid_march(p, cfg, t1, **CPU)
    kill_after_second_write()
    fp = CK.march_fingerprint(p.name, cfg, t1, "hybrid_march")
    assert CK.load_march_state(str(tmp_path / "hm"), fp)[0] == 16
    resumed = TR.hybrid_march(p, cfg, t1, **CPU)  # resumes at step 16
    assert torch.equal(resumed.coeffs, ref.coeffs)
    assert torch.equal(resumed.fem_values, ref.fem_values)
    shutil.rmtree(tmp_path / "hm")
    whole = TR.hybrid_march(p, cfg, t1, **CPU)  # uninterrupted, chunked
    assert torch.equal(whole.coeffs, ref.coeffs)
    loaded = TR.hybrid_march(p, cfg, t1, **CPU)  # finished: a pure load
    assert torch.equal(loaded.coeffs, ref.coeffs)


@pytest.mark.parametrize("march", ["fem_march_2d", "hybrid_wave_march_2d"])
def test_2d_march_checkpoint_bitwise(tmp_path, kill_after_second_write,
                                     march):
    """The 2D marches carry their CG iteration counts as per-step
    outputs: restored from the ys files, they give the same cg_iters."""
    fn = getattr(TR, march)
    p = TR.heat_2d() if march == "fem_march_2d" else TR.wave_2d()
    cfg = Solver2DConfig(nx=8, ny=8, M=6, n_colloc=6)
    base = TR.TransientConfig(t_final=0.25, n_steps=16, mass="numerov")
    t1 = dataclasses.replace(base, checkpoint=str(tmp_path / "m"),
                             checkpoint_chunk=4)

    def run(tcfg):
        out = fn(p, cfg, tcfg, **CPU)
        return out[0] if isinstance(out[0], tuple) else out

    ref = run(base)
    with pytest.raises(Killed):
        run(t1)
    kill_after_second_write()
    resumed = run(t1)
    assert torch.equal(resumed.fem_values, ref.fem_values)
    assert resumed.cg_iters == ref.cg_iters
    if ref.coeffs is not None:
        assert torch.equal(resumed.coeffs, ref.coeffs)
    loaded = run(t1)  # every step's iterations come from the ys files
    assert loaded.cg_iters == ref.cg_iters


def test_adaptive_march_checkpoint_resume(tmp_path,
                                          kill_after_second_write):
    """The attempt carry holds the running (t, dt), so a resumed run
    continues the attempt sequence exactly (resuming at attempt 32)."""
    p = TR.heat_1d()
    cfg = SolverConfig(num_nodes=33, dtype="float64")
    kw = dict(t_final=1.0, tol=1e-4, max_attempts=64,
              checkpoint=str(tmp_path / "ad"), checkpoint_chunk=16)
    plain = TR.fem_march_adaptive(p, cfg, t_final=1.0, tol=1e-4,
                                  max_attempts=64, **CPU)
    with pytest.raises(Killed):
        TR.fem_march_adaptive(p, cfg, **kw, **CPU)
    kill_after_second_write()
    fp = CK.march_fingerprint(p.name, cfg, TR._AdaptiveParams(
        1.0, 1e-4, None, 64), "fem_march_adaptive")
    assert CK.load_march_state(str(tmp_path / "ad"), fp)[0] == 32
    res = TR.fem_march_adaptive(p, cfg, **kw, **CPU)
    assert torch.equal(res.solution.fem_values, plain.solution.fem_values)
    for k in ("accepted", "rejected", "t_reached", "max_err"):
        assert torch.equal(getattr(res, k), getattr(plain, k)), k
    assert res.accepted.dtype == torch.int32


def test_format_is_the_jax_packages(tmp_path):
    """A state written by either package loads in the other, leaf for
    leaf."""
    leaves = [np.arange(6.0).reshape(2, 3), np.asarray(0.25),
              np.asarray(7, np.int32)]
    ys = [np.arange(4.0), np.asarray([1, 2, 3, 4], np.int64)]
    for writer, reader in ((JCK, CK), (CK, JCK)):
        path = str(tmp_path / writer.__name__)
        names = []
        writer._write_march(path, "fp", 4, [torch.as_tensor(v) if writer is
                                            CK else v for v in leaves],
                            ys, names)
        step, carry, ys_r, files = reader.load_march_state(path, "fp")
        assert step == 4 and files == names == ["ys_000000.npz"]
        for a, b in zip(carry + ys_r, leaves + ys):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_unported_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="AsyncCheckpointer"):
        CK.scan_checkpointed(_step, C0, TS, path=str(tmp_path / "a"),
                             checkpointer=object())
    with pytest.raises(NotImplementedError, match="callable carry0"):
        CK.chunked_scan(lambda c, t: CK.scan(_step, c, t), lambda: C0, TS,
                        path=str(tmp_path / "b"), fingerprint="fp")
    c, _ = CK.chunked_scan(lambda c, t: CK.scan(_step, c, t), lambda: C0,
                           TS)
    assert torch.equal(c, CK.scan(_step, C0, TS)[0])
