"""The port's LULESH (``repro_torch.models.lulesh``) and its stencil kernel
against the JAX reference, on the CPU.

States cross between the packages as numpy arrays, bit for bit.  On the
CPU the port's kernel entry point (``ops.sedov_step_kernel``) runs the
plain fused step ``ref.sedov_step_ref``; it is held against the
reference's Pallas kernel in interpret mode, as
``tests/test_kernels_stencil.py`` runs it.  Tolerances are scale-relative
(max |got - want| / max |want| per field):

* port oracle step vs reference oracle step, one step: 1e-6 (the same f32
  operations in the same order; rounding of the last bit only);
* ``run`` over 20-50 steps: 1e-5 (such differences carried by the blast);
* plain fused step vs the Pallas kernel, one step: 1e-6, boundary planes
  to rtol 1e-6 (the reference kernel test's own limits).

The CUDA kernel runs only on the card: its case is marked ``cuda`` and
skips here; ``chip_smoke.py`` holds it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import sedov_step_kernel as ref_sedov_kernel
from repro.kernels.sedov_stencil import cfl_dt as ref_cfl_dt
from repro.kernels.sedov_stencil import sedov_step_pallas
from repro.models import lulesh as ref_lulesh
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sedov_stencil import sedov_step_cuda
from repro_torch.models import lulesh

FIELDS = ("rho", "e", "v")


def _np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _ref_state(n, warm):
    """A reference state after ``warm`` oracle steps."""
    cfg = ref_lulesh.LuleshConfig(grid=n)
    st = ref_lulesh.init_state(cfg)
    for _ in range(warm):
        st = ref_lulesh.step(st, cfg)
    return cfg, st


def _rough_state(n, seed):
    """A state with every zone different (rho, e and v drawn from a seed),
    so that each tile seam of a blocked kernel sees varied data: a wrong
    neighbour there gives wrong numbers, where on the early blast's
    uniform gas it would give the same ones."""
    rng = np.random.default_rng(seed)
    return {"rho": rng.uniform(0.5, 2.0, (n, n, n)).astype(np.float32),
            "e": rng.uniform(5e3, 2e4, (n, n, n)).astype(np.float32),
            "v": rng.normal(0.0, 10.0, (3, n, n, n)).astype(np.float32),
            "t": np.float32(0.0)}


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _assert_close(got: dict, want: dict, tol, fields=FIELDS + ("t",)):
    for f in fields:
        err = _rel(np.asarray(got[f]), np.asarray(want[f]))
        assert err <= tol, (f, err)


@pytest.mark.parametrize("n", [1, 8, 13])
def test_init_state_equals_reference_bitwise(n):
    want = _np(ref_lulesh.init_state(ref_lulesh.LuleshConfig(grid=n)))
    got = lulesh.state_to_numpy(lulesh.init_state(lulesh.LuleshConfig(grid=n)))
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_state_numpy_roundtrip_is_exact():
    _, st = _ref_state(8, 2)
    back = lulesh.state_to_numpy(lulesh.state_from_numpy(_np(st)))
    for k, v in _np(st).items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("n,warm", [(8, 0), (13, 3), (16, 4)])
def test_step_matches_reference(n, warm):
    cfg, st = _ref_state(n, warm)
    want = _np(ref_lulesh.step(st, cfg))
    got = lulesh.state_to_numpy(lulesh.step(lulesh.state_from_numpy(_np(st)),
                                            lulesh.LuleshConfig(grid=n)))
    _assert_close(got, want, 1e-6)


@pytest.mark.parametrize("n,iters", [(16, 50), (32, 20)])
def test_run_matches_reference(n, iters):
    cfg = ref_lulesh.LuleshConfig(grid=n)
    want = _np(ref_lulesh.run(ref_lulesh.init_state(cfg), cfg, iters))
    pcfg = lulesh.LuleshConfig(grid=n)
    got = lulesh.state_to_numpy(lulesh.run(lulesh.init_state(pcfg), pcfg,
                                           iters))
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("n,bx", [(8, 4), (13, 13), (16, 8), (24, 8)])
def test_plain_fused_step_matches_reference_kernel(n, bx):
    _, st = _ref_state(n, 3)
    dt = ref_cfl_dt(st)
    want = _np(sedov_step_pallas(st, dt, block_x=bx, interpret=True))
    got = ref.sedov_step_ref(lulesh.state_from_numpy(_np(st)),
                             torch.tensor(np.asarray(dt)))
    _assert_close(lulesh.state_to_numpy(got), want, 1e-6)


@pytest.mark.parametrize("n,bx", [(8, 4), (13, 13), (16, 8), (24, 8)])
def test_plain_fused_step_matches_reference_kernel_on_rough_state(n, bx):
    """Every x-block seam of the Pallas kernel sees varied data; each zone
    of every field is held to rtol 1e-6 of the field's largest value."""
    st = _rough_state(n, seed=n)
    dt = ref_cfl_dt({k: jnp.asarray(a) for k, a in st.items()})
    want = _np(sedov_step_pallas({k: jnp.asarray(a) for k, a in st.items()},
                                 dt, block_x=bx, interpret=True))
    got = lulesh.state_to_numpy(ref.sedov_step_ref(
        lulesh.state_from_numpy(st), torch.tensor(np.asarray(dt))))
    for f in FIELDS + ("t",):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[f]).max(),
                                   err_msg=f)


def test_plain_fused_step_boundary_planes_exact():
    """The blast starts in the corner: the edge-clamped boundary of every
    derived field shows at step one."""
    _, st = _ref_state(16, 1)
    dt = ref_cfl_dt(st)
    want = _np(sedov_step_pallas(st, dt, block_x=4, interpret=True))
    got = lulesh.state_to_numpy(ref.sedov_step_ref(
        lulesh.state_from_numpy(_np(st)), torch.tensor(np.asarray(dt))))
    for f in ("rho", "e"):
        for plane in (0, -1):
            np.testing.assert_allclose(got[f][plane], want[f][plane],
                                       rtol=1e-6)
            np.testing.assert_allclose(got[f][:, plane], want[f][:, plane],
                                       rtol=1e-6)
            np.testing.assert_allclose(got[f][..., plane],
                                       want[f][..., plane], rtol=1e-6)


@pytest.mark.parametrize("n,warm", [(8, 0), (16, 3)])
def test_cfl_dt_matches_reference(n, warm):
    _, st = _ref_state(n, warm)
    got = ref.cfl_dt(lulesh.state_from_numpy(_np(st)))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref_cfl_dt(st)), rtol=1e-6)


def test_kernel_entry_point_matches_reference_kernel_on_cpu():
    """``ops.sedov_step_kernel`` on CPU tensors: the CFL reduction, then the
    plain fused step — the reference's ``ops.sedov_step_kernel``."""
    cfg, st = _ref_state(16, 2)
    want = _np(ref_sedov_kernel(st, cfg, block_x=8, interpret=True))
    got = ops.sedov_step_kernel(lulesh.state_from_numpy(_np(st)),
                                lulesh.LuleshConfig(grid=16))
    _assert_close(lulesh.state_to_numpy(got), want, 1e-6)


def test_kernel_run_trajectory_matches_reference():
    """10 fused steps stay glued to 10 reference oracle steps (the
    reference kernel test's multi-step limit)."""
    cfg = ref_lulesh.LuleshConfig(grid=16)
    want = _np(ref_lulesh.run(ref_lulesh.init_state(cfg), cfg, 10))
    pcfg = lulesh.LuleshConfig(grid=16)
    got = lulesh.state_to_numpy(lulesh.run(lulesh.init_state(pcfg), pcfg, 10,
                                           use_kernel=True))
    _assert_close(got, want, 1e-4, fields=("rho", "e"))


def test_blast_wave_propagates():
    """tests/test_models_smoke.py's blast-wave checks, on the port."""
    cfg = lulesh.LuleshConfig(grid=16)
    st = lulesh.run(lulesh.init_state(cfg), cfg, 20)
    assert bool(torch.isfinite(st["e"]).all())
    assert bool(torch.isfinite(st["rho"]).all())
    assert float(st["e"][1, 0, 0]) > 1e3     # wavefront reached neighbors
    assert float((st["rho"] - 1.0).abs().max()) > 1e-3
    assert float(st["t"]) > 0


def test_step_refuses_a_mesh():
    cfg = lulesh.LuleshConfig(grid=4)
    with pytest.raises(NotImplementedError, match="slice G"):
        lulesh.step(lulesh.init_state(cfg), cfg, mesh=object())


def test_fom_matches_reference():
    assert lulesh.fom(13 ** 3, 1000, 2.5) == ref_lulesh.fom(13 ** 3, 1000, 2.5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback inside the wrapper: CPU tensors go to the plain
    version through ``ops``, never through ``sedov_step_cuda``."""
    st = lulesh.init_state(lulesh.LuleshConfig(grid=4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sedov_step_cuda(st, ref.cfl_dt(st))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["blast", "rough"])
@pytest.mark.parametrize("n", [1, 13, 33, 40])
def test_cuda_kernel_matches_plain(n, kind):
    """The kernel (built with -fmad=false) rounds as the plain version
    does: every zone of every field to rtol 1e-6.  The rough state puts
    varied data on every tile seam (tiles are 8 x 8 x 32; n = 40 has
    seams on all three axes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    cfg = lulesh.LuleshConfig(grid=n)
    if kind == "blast":
        st = lulesh.run(lulesh.init_state(cfg, "cuda"), cfg, 3)
    else:
        st = lulesh.state_from_numpy(_rough_state(n, seed=n), "cuda")
    dt = ref.cfl_dt(st)
    before = sedov_step_cuda.launches
    got = sedov_step_cuda(st, dt)
    assert sedov_step_cuda.launches == before + 1
    want = ref.sedov_step_ref(st, dt)
    for f in FIELDS + ("t",):
        torch.testing.assert_close(got[f], want[f], rtol=1e-6, atol=0.0,
                                   msg=f)
