"""PyTorch port (mythos_tpu_torch): the native oxDNA trajectory parser
(``io/native.py``, the repo's ``native/traj_parser.cpp`` built with g++
into the port's own build directory) against the reference's ``from_file``
and the port's numpy parser; and the fitting loop's loggers and
SimulatorTrajectory helpers against the reference's.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import jax.numpy as jnp  # noqa: E402

from mythos_tpu.io import trajectory as jtraj  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.simulators.io import SimulatorTrajectory as JaxTrajectory  # noqa: E402
from mythos_tpu_torch.io import native  # noqa: E402
from mythos_tpu_torch.io import trajectory as ttraj  # noqa: E402
from mythos_tpu_torch.simulators.io import SimulatorTrajectory  # noqa: E402

N_BP = 8
N = 2 * N_BP
KT = 296.15 * 0.1 / 300.0
REPO_NATIVE = native.SRC.parent


def _states(n_states: int, seed: int, scale: float = 0.02):
    _, body = jax_duplex(N_BP)
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center)[None] + scale * rng.standard_normal((n_states, N, 3))
    q = np.asarray(body.orientation)[None] + scale * rng.standard_normal((n_states, N, 4))
    return c, q / np.linalg.norm(q, axis=-1, keepdims=True)


def _native_dir_listing() -> dict:
    """``native/`` but the reference's own library, which the reference's
    from_file (here or in another test process) builds there at first use."""
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in REPO_NATIVE.iterdir()
            if p.name != "libmythos_traj.so"}


def test_native_parser_matches_reference_and_numpy(tmp_path):
    """A 3-state, two-strand trajectory of 12 + 9 nucleotides with varied
    number formats: the native parser equals the port's numpy parser, and
    the port's from_file (the native parser) the reference's from_file,
    with and without the per-strand flip, to the last bit; the library is
    built from ``native/traj_parser.cpp`` into the port's own build
    directory, never into ``native/``, where the port adds and changes no
    file (the reference's library there is the reference's to build); a
    malformed file makes the native parser decline and the numpy parser
    raise."""
    rng = np.random.default_rng(0)
    strands = [12, 9]
    n = sum(strands)
    lines = []
    for s in range(3):
        lines += [f"t = {1000 * s}", "b = 20.0 20.0 20.0", f"E = {-1.25 * s:.6f} 0.5 1e-3"]
        block = rng.standard_normal((n, 15)) * 10.0 ** rng.integers(-3, 3, (n, 15))
        lines += [" ".join(f"{v:.17g}" if (i + j) % 3 else f"{v:.6e}" for j, v in enumerate(row))
                  for i, row in enumerate(block)]
    path = tmp_path / "traj.dat"
    path.write_text("\n".join(lines) + "\n")

    before = _native_dir_listing()
    lib_path = native.library_path()
    assert lib_path is not None and native.BUILD_ROOT in lib_path.parents
    assert REPO_NATIVE not in lib_path.parents
    fresh = tmp_path / "build" / native.LIB_NAME
    assert native._build(fresh) and fresh.exists()
    assert native.get_lib() is not None and lib_path.exists()
    parsed = native.parse_trajectory(path, n)
    assert parsed is not None
    for got, plain in zip(parsed, ttraj.parse_numpy(path, n), strict=True):
        np.testing.assert_array_equal(got, np.asarray(plain))
    for flip in (True, False):
        got = ttraj.from_file(path, strands, is_5p_3p=flip)
        want = jtraj.from_file(path, strands, is_5p_3p=flip)
        np.testing.assert_array_equal(np.stack([s.array for s in got.states]), np.stack([s.array for s in want.states]))
        np.testing.assert_array_equal(got.times, want.times)
        np.testing.assert_array_equal(got.energies, want.energies)
        np.testing.assert_array_equal(np.asarray(got.box_size), np.asarray(want.box_size))
    assert _native_dir_listing() == before

    bad = tmp_path / "bad.dat"
    bad.write_text("\n".join(lines[:-1]) + "\n")
    assert native.parse_trajectory(bad, n) is None
    with pytest.raises(ValueError, match="Malformed"):
        ttraj.from_file(bad, strands)
    assert _native_dir_listing() == before
    assert not any(p.suffix == ".tmp" for p in lib_path.parent.iterdir()), os.listdir(lib_path.parent)


def test_loggers_and_trajectory_helpers_match_reference(tmp_path, capsys):
    """The loggers print and write the reference's lines (timestamps aside),
    their status helpers included; SimulatorTrajectory's slice (int, slice,
    index list), filter, concat (NaN-filled metadata, refused mismatches),
    ``+`` and to_file give the reference's states, temperatures, metadata
    and file (numbers parsed, rtol 1e-12)."""
    import mythos_tpu.ui.loggers as jlog
    import mythos_tpu_torch.ui.loggers as tlog

    outputs = {}
    for name, mod in (("jax", jlog), ("port", tlog)):
        sub = tmp_path / name
        sub.mkdir()
        console, per_metric = mod.ConsoleLogger(), mod.PerMetricFileLogger(sub / "metrics")
        file_logger = mod.FileLogger(sub / "all.csv")
        multi = mod.MultiLogger([console, file_logger, per_metric, mod.NullLogger()])
        multi.log_metric("fit.loss", 1.25, step=3)
        multi.log_metric("fit/neff", 0.5, step=4)
        multi.set_simulator_started("sim")
        multi.update_objective_status("fit", mod.Status.COMPLETE)
        multi.set_observable_error("twist")
        file_logger.log_file.close()
        for fh in per_metric.file_handles.values():
            fh.close()
        files = {p.relative_to(sub).as_posix(): [",".join(x for x in ln.split(",") if "T" not in x or ":" not in x)
                                                 for ln in p.read_text().splitlines()]
                 for p in sorted(sub.rglob("*.csv"))}
        outputs[name] = (capsys.readouterr().out, files)
    assert outputs["port"] == outputs["jax"]
    assert "Step: 3, fit.loss: 1.25" in outputs["port"][0]

    c, q = _states(5, seed=2)
    kts = np.array([KT, KT, 2 * KT, KT, 2 * KT])
    flags = np.array([True, False, True, False, False])
    t_j = JaxTrajectory(center=jnp.asarray(c), orientation=jnp.asarray(q), temperature=jnp.asarray(kts),
                        box_size=jnp.full((5, 3), 30.0)).with_state_metadata(tag=1.5)
    t_j = t_j.replace(metadata={**t_j.metadata, "flag": jnp.asarray(flags)})
    t = SimulatorTrajectory(center=torch.as_tensor(c), orientation=torch.as_tensor(q), temperature=torch.as_tensor(kts),
                            box_size=torch.full((5, 3), 30.0, dtype=torch.float64)).with_state_metadata(tag=1.5)
    t = t.replace(metadata={**t.metadata, "flag": torch.as_tensor(flags)})

    def same(a_t, a_j):
        for f in ("center", "orientation", "temperature", "box_size"):
            np.testing.assert_allclose(getattr(a_t, f).numpy(), np.asarray(getattr(a_j, f)), rtol=1e-12, err_msg=f)
        assert set(a_t.metadata) == set(a_j.metadata)
        for k in a_t.metadata:
            np.testing.assert_array_equal(a_t.metadata[k].numpy(), np.asarray(a_j.metadata[k]), err_msg=k)

    for key in (2, slice(1, 4), [0, 3, 4]):
        same(t.slice(key), t_j.slice(key))
    same(t.filter(lambda m: m["flag"]), t_j.filter(lambda m: m["flag"]))
    bare_j, bare = t_j.slice(slice(0, 2)).replace(metadata=None), t.slice(slice(0, 2)).replace(metadata=None)
    same(t.slice(slice(2, 5)) + bare, t_j.slice(slice(2, 5)) + bare_j)
    same(SimulatorTrajectory.concat([t, t.slice(1)]), JaxTrajectory.concat([t_j, t_j.slice(1)]))
    with pytest.raises(ValueError, match="incompatible temperatures"):
        SimulatorTrajectory.concat([t, t.replace(temperature=None)])
    with pytest.raises(ValueError, match="mismatched shapes"):
        SimulatorTrajectory.concat([t, t.replace(metadata={"tag": torch.zeros(5, 2)})])
    t.to_file(tmp_path / "port.dat")
    t_j.to_file(tmp_path / "jax.dat")
    lines_t, lines_j = ((tmp_path / f).read_text().splitlines() for f in ("port.dat", "jax.dat"))
    assert len(lines_t) == len(lines_j) == 5 * (3 + N)
    for a, b in zip(lines_t, lines_j, strict=True):
        head_a, head_b = a.split("=")[0] if "=" in a else "", b.split("=")[0] if "=" in b else ""
        assert head_a == head_b
        np.testing.assert_allclose(np.array(a.split("=")[-1].split(), float), np.array(b.split("=")[-1].split(), float),
                                   rtol=1e-12, atol=1e-14)
    assert math.isclose(float(t.slice(0).temperature[0]), KT)
