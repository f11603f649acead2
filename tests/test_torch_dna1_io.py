"""PyTorch port (mythos_tpu_torch): the oxDNA file readers -- topology files
(classic and new format), trajectories and input files -- against the JAX
package's, in both directions, on files written here (the golden data is
absent).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import mythos_tpu.io.oxdna_input as joi  # noqa: E402
import mythos_tpu.io.topology as jtop  # noqa: E402
import mythos_tpu.io.trajectory as jtraj  # noqa: E402
import mythos_tpu_torch.io.oxdna_input as toi  # noqa: E402
import mythos_tpu_torch.io.topology as ttop  # noqa: E402
import mythos_tpu_torch.io.trajectory as ttraj  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402

CLASSIC = """8 2
1 A -1 1
1 C 0 2
1 G 1 3
1 T 2 -1
2 A -1 5
2 C 4 6
2 G 5 7
2 T 6 -1
"""
NEW = """9 2 5->3
ACGTA type=DNA circular=false
UGCA type=RNA
"""
CIRCULAR = """5 1
1 G 4 1
1 C 0 2
1 A 1 3
1 U 2 4
1 G 3 0
"""
FILES = {"classic": CLASSIC, "new": NEW, "circular": CIRCULAR,
         "new_circular": "6 1 5->3\nACGTAC type=DNA circular=true\n"}
MALFORMED = {
    "four_fields": "8 2 5->3 x\nACGT\n",
    "count_mismatch": "9 2\n1 A -1 1\n1 C 0 -1\n",
    "bad_base": "3 1 5->3\nAXG type=DNA\n",
}


def _read_both(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jtop.from_oxdna_file(path, return_format=True), ttop.from_oxdna_file(path, return_format=True)


@pytest.mark.parametrize("name", sorted(FILES))
def test_topology_files_match_jax(name, tmp_path):
    """Both packages read the same topology file (classic, new, circular
    strands) into the same sequence, bonds, unbonded pairs, strand lengths,
    termini and types, and sniff the same format."""
    path = tmp_path / f"{name}.top"
    path.write_text(FILES[name])
    (ref, ref_fmt), (got, got_fmt) = _read_both(path)
    assert got_fmt.value == ref_fmt.value
    assert got.n_nucleotides == ref.n_nucleotides
    for field in ("seq", "bonded_neighbors", "unbonded_neighbors", "strand_counts", "is_end", "nt_type"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)), np.asarray(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_topology_errors_match_jax(name, tmp_path):
    """A malformed file raises the reference's error, type and message."""
    path = tmp_path / f"{name}.top"
    path.write_text(MALFORMED[name])
    errors = []
    for reader in (jtop.from_oxdna_file, ttop.from_oxdna_file):
        with pytest.raises(Exception) as info, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            reader(path)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_missing_topology_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match=jtop.ERR_FILE_NOT_FOUND):
        ttop.from_oxdna_file(tmp_path / "absent.top")


@pytest.fixture(scope="module")
def trajectory_file(tmp_path_factory):
    """A 3-state trajectory of the 20-bp duplex (jittered, with velocities)
    written by the reference's Trajectory.to_file."""
    top, body = jax_duplex(20)
    rng = np.random.default_rng(0)
    n = top.n_nucleotides
    q = np.asarray(body.orientation)
    w, x, y, z = q.T
    a1 = np.stack([w * w + x * x - y * y - z * z, 2 * (x * y + w * z), 2 * (x * z - w * y)], -1)
    a3 = np.stack([2 * (x * z + w * y), 2 * (y * z - w * x), w * w - x * x - y * y + z * z], -1)
    states = []
    for k in range(3):
        com = np.asarray(body.center) + 0.05 * k * rng.standard_normal((n, 3))
        states.append(jtraj.NucleotideState(array=np.concatenate(
            [com, a1, a3, 0.1 * rng.standard_normal((n, 3)), 0.1 * rng.standard_normal((n, 3))], axis=1)))
    ref = jtraj.Trajectory(n_nucleotides=n, strand_lengths=[int(c) for c in top.strand_counts],
                           times=np.array([0.0, 100.0, 200.0]), energies=rng.standard_normal((3, 3)),
                           states=states, box_size=np.array([40.0, 40.0, 40.0]))
    path = tmp_path_factory.mktemp("traj") / "trajectory.dat"
    ref.to_file(path)
    return path, ref


@pytest.mark.parametrize("is_5p_3p", [True, False])
def test_trajectory_read_matches_jax(is_5p_3p, trajectory_file):
    """The port's from_file reads the reference-written trajectory as the
    reference's from_file does (times, energies, box, states; the 5'->3'
    flip or not), and to_rigid_body gives its bodies within 1e-12."""
    path, written = trajectory_file
    lengths = written.strand_lengths
    ref = jtraj.from_file(path, lengths, is_5p_3p=is_5p_3p)
    got = ttraj.from_file(path, lengths, is_5p_3p=is_5p_3p)
    for field in ("times", "energies", "box_size"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(ref, field)), err_msg=field)
    assert len(got.states) == len(ref.states) == 3
    for a, b in zip(got.states, ref.states, strict=True):
        np.testing.assert_array_equal(a.array, b.array)
        body_j = b.to_rigid_body()
        body_t = a.to_rigid_body(device="cpu")
        np.testing.assert_allclose(body_t.center.numpy(), np.asarray(body_j.center), rtol=0, atol=1e-12)
        np.testing.assert_allclose(body_t.orientation.numpy(), np.asarray(body_j.orientation), rtol=0, atol=1e-12)


def test_trajectory_write_read_back_by_jax(trajectory_file, tmp_path):
    """The port writes the trajectory back (to_file), and the reference
    reads it as it reads its own file."""
    path, written = trajectory_file
    lengths = written.strand_lengths
    got = ttraj.from_file(path, lengths, is_5p_3p=False)
    out = tmp_path / "back.dat"
    got.to_file(out)
    ref, again = jtraj.from_file(path, lengths, is_5p_3p=False), jtraj.from_file(out, lengths, is_5p_3p=False)
    for a, b in zip(again.states, ref.states, strict=True):
        np.testing.assert_array_equal(a.array, b.array)
    np.testing.assert_array_equal(again.times, ref.times)
    np.testing.assert_array_equal(again.energies, ref.energies)


def test_malformed_trajectory_raises(trajectory_file, tmp_path):
    """A trajectory with a row missing, and one with a box that changes,
    raise as the reference's (its numpy path's messages)."""
    path, written = trajectory_file
    lines = path.read_text().splitlines()
    short = tmp_path / "short.dat"
    short.write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError, match="Malformed trajectory file"):
        ttraj.from_file(short, written.strand_lengths)
    moving = tmp_path / "moving.dat"
    moving.write_text("\n".join(ln.replace("b = 40.0 40.0 40.0", "b = 41.0 40.0 40.0") if i > 10 else ln
                                for i, ln in enumerate(lines)) + "\n")
    with pytest.raises(ValueError, match=ttraj.ERR_FIXED_BOX_SIZE):
        ttraj.from_file(moving, written.strand_lengths)


def test_oxdna_input_files_match_jax(tmp_path):
    """read of a written input file (nested blocks, typed values, a comment,
    a temperature) gives the reference's dict; the port's write reads back
    the same; read_input_dir gives the reference's topology, kT and box."""
    config = {"backend": "CPU", "T": 296.15, "steps": 1000, "dt": 0.005, "verlet_skin": 0.05,
              "use_average_seq": False, "topology": "sys.top", "conf_file": "init.conf",
              "external_forces_file": {"type": "trap", "stiff": 1.5, "group": {"name": "a", "on": True}}}
    path = tmp_path / "input"
    joi.write(config, path)
    with path.open("a") as f:
        f.write("# a comment\nsalt_concentration = 0.5 # molar\n")
    assert toi.read(path) == joi.read(path)
    back = tmp_path / "input_back"
    toi.write(toi.read(path), back)
    assert joi.read(back) == joi.read(path)
    (tmp_path / "sys.top").write_text(CLASSIC)
    (tmp_path / "init.conf").write_text("t = 0\nb = 20.0 20.0 30.0\nE = 0 0 0\n" + "0 " * 15 + "\n")
    ref, got = joi.read_input_dir(tmp_path), toi.read_input_dir(tmp_path)
    assert got.kT == pytest.approx(ref.kT, rel=1e-15)
    np.testing.assert_array_equal(got.box_size, ref.box_size)
    np.testing.assert_array_equal(got.topology.bonded_neighbors, ref.topology.bonded_neighbors)
    assert got.config == ref.config
