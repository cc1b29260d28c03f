"""The port's exporters (``tinysplat_torch.io.export``, ``export_cli``) vs the
JAX package's (``tinysplat_tpu.io.export``, ``scripts/export.py``).

A JAX state (SH degree 3, 150 live splats in 256 slots, some dead slots in
the middle) carried across with ``from_jax_params``: the PLY and .splat
files are byte-identical, each package imports the other's PLY back to the
same live arrays, and ``export_cli --device cpu`` on a port checkpoint
writes the same bytes as the JAX exporters on a JAX load of it.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tinysplat_tpu.io.checkpoint import load_model as jax_load_model
from tinysplat_tpu.io.export import export_ply as jax_export_ply
from tinysplat_tpu.io.export import export_splat as jax_export_splat
from tinysplat_tpu.io.export import import_ply as jax_import_ply
from tinysplat_tpu.models import gaussians as jg

import tinysplat_torch as tt
from tinysplat_torch import export_cli
from tinysplat_torch.io.checkpoint import save_checkpoint
from tinysplat_torch.io.export import export_mesh_obj, export_ply, export_splat, import_ply
from tinysplat_torch.models.gaussians import PARAM_FIELDS

from tests._torch_threads import one_torch_thread  # noqa: F401

N, CAP = 150, 256


def _jax_state():
    rng = np.random.default_rng(11)
    alive = np.zeros(CAP, bool)
    alive[rng.choice(CAP, N, replace=False)] = True
    params = {
        "means": rng.normal(size=(CAP, 3)),
        "colors_dc": rng.normal(size=(CAP, 3)),
        "colors_rest": rng.normal(size=(CAP, 15, 3)) * 0.1,
        "scales": rng.uniform(-5, -1, size=(CAP, 3)),
        "quats": rng.normal(size=(CAP, 4)),
        "opacities": rng.normal(size=(CAP, 1)) * 3,
    }
    return jg.GaussianState(
        params=jg.GaussianParams(**{k: jnp.asarray(v, jnp.float32) for k, v in params.items()}),
        alive=jnp.asarray(alive), means_grad_accum=jnp.zeros((CAP,), jnp.float32),
        active_sh_degree=jnp.int32(3))


def _port_state(jstate):
    d = {k: np.asarray(getattr(jstate.params, k)) for k in PARAM_FIELDS}
    d.update(alive=np.asarray(jstate.alive), active_sh_degree=int(jstate.active_sh_degree))
    return tt.from_jax_params(d, "cpu")


def _live(state):
    sd = tt.state_dict(state) if hasattr(state.alive, "numpy") else jg.state_dict(state)
    return {k: np.asarray(sd[k]) for k in PARAM_FIELDS}


@pytest.mark.parametrize("fmt", ["ply", "splat"])
def test_files_are_byte_identical_to_jax(tmp_path, fmt):
    jstate = _jax_state()
    ours, theirs = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    {"ply": export_ply, "splat": export_splat}[fmt](_port_state(jstate), str(ours))
    {"ply": jax_export_ply, "splat": jax_export_splat}[fmt](jstate, str(theirs))
    data = ours.read_bytes()
    assert data == theirs.read_bytes()
    if fmt == "splat":
        assert len(data) == 32 * N


def test_each_package_imports_the_others_ply(tmp_path):
    jstate = _jax_state()
    ref = _live(jstate)
    export_ply(_port_state(jstate), str(tmp_path / "port.ply"))
    jax_export_ply(jstate, str(tmp_path / "jax.ply"))
    got = import_ply(str(tmp_path / "jax.ply"), device="cpu")
    jgot = jax_import_ply(str(tmp_path / "port.ply"))
    assert got.capacity == jgot.capacity and int(got.active_sh_degree) == 3
    for name in PARAM_FIELDS:
        np.testing.assert_array_equal(_live(got)[name], ref[name], err_msg=name)
        np.testing.assert_array_equal(_live(jgot)[name], ref[name], err_msg=name)


@pytest.mark.parametrize("filetype,ext,jax_writer",
                         [("PLY", "ply", jax_export_ply), ("SPLAT", "splat", jax_export_splat)])
def test_export_cli_matches_the_jax_exporters(tmp_path, filetype, ext, jax_writer):
    jstate = _jax_state()
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, _port_state(jstate), step=3)
    out = tmp_path / f"port.{ext}"
    export_cli.main(["--filetype", filetype, "--device", "cpu", ckpt, str(out)])
    jax_writer(jax_load_model(ckpt), str(tmp_path / f"jax.{ext}"))
    assert out.read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    # A PLY as the input: back to the same bytes.
    if filetype == "PLY":
        again = tmp_path / "again.ply"
        export_cli.main(["--filetype", "PLY", "--device", "cpu", str(out), str(again)])
        assert again.read_bytes() == out.read_bytes()


def test_export_cli_obj_raises_and_names_item_15(tmp_path):
    """Item 15 landed: OBJ export writes a mesh (both algorithms are held in
    tests/test_torch_port_mesh.py); a missing checkpoint still raises
    before anything is written."""
    with pytest.raises(FileNotFoundError):
        export_cli.main(["--filetype", "OBJ", "--device", "cpu", str(tmp_path / "ck.npz"),
                         str(tmp_path / "m.obj")])
    assert not (tmp_path / "m.obj").exists()
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, _port_state(_jax_state()), step=3)
    summary = export_cli.main(["--filetype", "OBJ", "--device", "cpu", "--resolution", "16",
                               ckpt, str(tmp_path / "m.obj")])
    text = (tmp_path / "m.obj").read_text()
    assert summary["faces"] > 0 and text.count("\nf ") == summary["faces"]


def test_mesh_obj_writer_matches_jax(tmp_path):
    from tinysplat_tpu.io.export import export_mesh_obj as jax_export_mesh_obj

    rng = np.random.default_rng(2)
    verts, faces = rng.normal(size=(12, 3)), rng.integers(0, 12, size=(9, 3))
    normals = rng.normal(size=(12, 3))
    for nrm in (None, normals):
        export_mesh_obj(str(tmp_path / "a.obj"), verts, faces, nrm)
        jax_export_mesh_obj(str(tmp_path / "b.obj"), verts, faces, nrm)
        assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()
