"""The dry run's accounting in one process (``launch/op_analysis.py``,
``launch/roofline.py``, ``launch/report.py``, the kernel wrappers' fake
route): held against the JAX package's ``roofline`` and ``report`` on the
same numbers, against ``test_hlo_analysis``'s checks, and against each
kernel's own formula.  The fake process groups are in
``test_torch_dryrun_mesh.py``.
"""

import json
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.launch.report as jax_report
import repro.launch.roofline as jax_roofline
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_preprocess import fused_preprocess
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.launch import report, roofline
from repro_torch.launch.mesh import H100
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models.layers import maybe_remat
from repro_torch.models.model import build_model


# ------------------------------------------------------------ model flops
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_active_params_equal_jax(arch):
    n = roofline.active_param_count(ARCHS[arch], build_model(ARCHS[arch]))
    want = jax_roofline.active_param_count(
        JAX_ARCHS[arch], jax_build_model(JAX_ARCHS[arch]))
    assert n == want
    for shape in SHAPES:
        assert roofline.model_flops(ARCHS[arch], SHAPES[shape], n) == \
            jax_roofline.model_flops(JAX_ARCHS[arch], JAX_SHAPES[shape], n)


# --------------------------------------------------------------- roofline
FIELDS = dict(arch="gemma-2b", shape="train_4k", mesh="single", chips=256,
              flops_per_device=3.1e15, bytes_per_device=2.2e13,
              collective_bytes=4.5e9,
              collective_breakdown={"all-gather": 3000000000,
                                    "reduce-scatter": 1500000000},
              peak_memory_per_device=6.1e10, model_flops_total=2.6e17)


def test_roofline_terms_equal_jax_on_the_same_figures(monkeypatch):
    monkeypatch.setitem(jax_roofline.HW, "peak_flops_bf16",
                        H100["peak_flops"]["bfloat16"])
    monkeypatch.setitem(jax_roofline.HW, "hbm_bw", H100["hbm_bw"])
    port, ref = roofline.Roofline(**FIELDS), jax_roofline.Roofline(**FIELDS)
    # the links differ (H100: NVLink or InfiniBand), so neither bound is
    # the collective term here
    assert port.dominant == ref.dominant != "collective"
    for term in ("compute_s", "memory_s", "useful_flops_ratio",
                 "roofline_fraction"):
        assert getattr(port, term) == getattr(ref, term), term
    # fp32 flops at the CUDA cores' rate
    mixed = roofline.Roofline(**FIELDS, flops_by_dtype={
        "bfloat16": 3.0e15, "float32": 1.0e14})
    assert mixed.compute_s == pytest.approx(3.0e15 / 989e12 + 1.0e14 / 67e12,
                                            rel=1e-12)


@pytest.mark.parametrize("across", [0.0, 1.0], ids=["inside", "across"])
def test_collective_term_takes_the_group_s_link(across):
    rl = roofline.Roofline(**FIELDS,
                           collective_bytes_across_nodes=across * 4.5e9)
    link = H100["ib_bw"] if across else H100["nvlink_bw"]
    assert rl.collective_s == pytest.approx(2.0 * 4.5e9 / link, rel=1e-12)
    assert rl.bound_s == max(rl.compute_s, rl.memory_s, rl.collective_s)
    assert rl.to_json()["dominant"] == rl.dominant


# ----------------------------------------------------------------- report
def _cells(tmp_path):
    """Three cells of each mesh kind as the dry run writes them, with the
    JAX dry run's ``compile_s`` beside the port's ``trace_s``."""
    cells = [("gemma-2b", "train_4k", 0.9), ("qwen2-72b", "decode_32k", 0.3),
             ("mamba2-1.3b", "long_500k", 0.05)]
    for mesh in ("single", "multi"):
        for i, (arch, shape, frac) in enumerate(cells):
            rl = roofline.Roofline(**dict(
                FIELDS, arch=arch, shape=shape, mesh=mesh,
                flops_per_device=FIELDS["flops_per_device"] * (i + 1),
                bytes_per_device=FIELDS["bytes_per_device"] / frac))
            d = {"arch": arch, "shape": shape, "mesh": mesh, "status": "OK",
                 "params_total": 2.5e9 * (i + 1), "trace_s": 12.5 + i,
                 "compile_s": 12.5 + i,
                 "memory_analysis": {"argument_bytes": 1e9 * (i + 1),
                                     "output_bytes": 1e9, "temp_bytes": 3e9,
                                     "alias_bytes": 1e9},
                 "collective_counts": {"all-gather": 10 + i,
                                       "reduce-scatter": 3},
                 "roofline": rl.to_json()}
            (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
                json.dumps(d))
        (tmp_path / f"gemma-2b__long_500k__{mesh}.json").write_text(
            json.dumps({"arch": "gemma-2b", "shape": "long_500k",
                        "mesh": mesh, "status": "SKIP(full-attention)"}))


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_report_tables_equal_jax_over_the_same_json(tmp_path, monkeypatch,
                                                    mesh):
    _cells(tmp_path)
    monkeypatch.setattr(jax_report, "OUT_DIR", tmp_path)
    monkeypatch.setattr(report, "OUT_DIR", tmp_path)
    assert report.roofline_table(mesh) == jax_report.roofline_table(mesh)
    # two columns' names: the port traces and counts where JAX compiles
    # and reads HLO
    assert report.dryrun_table(mesh) == jax_report.dryrun_table(mesh).replace(
        "| compile |", "| trace |").replace("| HLO flops/dev |",
                                            "| flops/dev |")
    assert report.pick_hillclimb(mesh) == jax_report.pick_hillclimb(mesh)
    assert len(report.load_cells(mesh)) == 4


# ----------------------------------------------- the counter's arithmetic
def _counted(fn, *shapes, dtype=torch.float32):
    with FakeTensorMode():
        args = [torch.empty(s, dtype=dtype) for s in shapes]
        counter = OpCounter()
        with counter:
            fn(*args)
    return counter.costs


def test_matmul_flops_are_2mnk():
    costs = _counted(lambda a, b: (a @ b).sum(), (256, 512), (512, 128))
    assert costs.flops == 2 * 256 * 512 * 128
    assert costs.flops_by_dtype == {"float32": 2 * 256 * 512 * 128}


def test_a_24_step_loop_counts_24_times():
    def loop(xs):
        c = torch.zeros(128, 128)
        for x in xs:
            c = torch.tanh(c @ x)
        return c.sum()
    costs = _counted(loop, (24, 128, 128))
    assert costs.flops == 24 * 2 * 128 ** 3


def test_remat_full_train_step_flops_in_expected_band():
    """Forward, its recompute and two products in the backward: [3, 4.5]x
    the forward (held; the JAX package's version of this is xfail)."""
    L, T, D, F = 8, 512, 256, 1024

    def grads(wi, wo, x):
        wi, wo = wi.requires_grad_(), wo.requires_grad_()
        body = maybe_remat(lambda h, a, b: torch.tanh(h @ a) @ b, "full")
        h = x
        for i in range(L):
            h = body(h, wi[i], wo[i])
        return torch.autograd.grad((h * h).sum(), (wi, wo))
    costs = _counted(grads, (L, D, F), (L, F, D), (T, D),
                     dtype=torch.bfloat16)
    fwd = L * 2 * (2 * T * D * F)
    assert 3.0 <= costs.flops / fwd <= 4.5
    assert costs.hbm_bytes < 600e6


def test_peak_follows_live_storage():
    def fn(x):
        y = x * 2          # 4 MB alive
        z = y + 1          # 8 MB alive
        del y
        w = z * 3          # 8 MB alive again
        return w
    costs = _counted(fn, (1024, 1024))
    assert costs.peak_bytes == 2 * 1024 * 1024 * 4
    assert costs.hbm_bytes == 3 * 2 * 1024 * 1024 * 4


# ------------------------------------------------- the kernels' fake route
def _fake_call(fn, inputs):
    """``fn`` on fake copies of ``inputs`` under a counter -> (its output,
    the costs, the storages it allocated)."""
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in inputs]
        counter = OpCounter()
        with counter:
            out = fn(*fake)
    return out, counter.costs


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_flash_counts_its_formula(dtype, window):
    B, S, H, Hkv, D = 2, 64, 4, 2, 32
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, h, D, generator=g).to(dtype)
               for h in (H, Hkv, Hkv))
    before = flash_attention.launches
    out, costs = _fake_call(
        lambda q, k, v: flash_attention(q, k, v, window=window), (q, k, v))
    real = flash_attention(q, k, v, window=window)      # the plain version
    assert flash_attention.launches == before
    assert (out.shape, out.dtype) == (real.shape, real.dtype)
    pairs = sum(min(i + 1, window or S) for i in range(S))
    assert fa_ops.pairs(S, S, True, window) == pairs
    assert costs.kernel_calls == {"flash_attention": 1}
    assert costs.flops == 4 * B * H * D * pairs
    assert costs.flops_by_dtype == {str(dtype)[6:]: 4 * B * H * D * pairs}
    assert costs.hbm_bytes == (2 * B * S * H * D + 2 * B * S * Hkv * D) * \
        q.element_size()
    assert costs.peak_bytes == out.numel() * out.element_size()


@pytest.mark.parametrize("T,pos", [(64, 63), (4096, 4000)])
def test_fake_decode_counts_its_formula_and_plans_for_an_h100(T, pos):
    B, H, Hkv, D = 1, 8, 1, 256
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, D, generator=g).bfloat16()
    ck, cv = (torch.randn(B, T, Hkv, D, generator=g).bfloat16()
              for _ in range(2))
    out, costs = _fake_call(
        lambda q, k, v: decode_attention(q, k, v, pos=pos), (q, ck, cv))
    real = decode_attention(q, ck, cv, pos=pos)
    assert (out.shape, out.dtype) == (real.shape, real.dtype)
    limit = pos + 1
    assert costs.kernel_calls == {"decode_attention": 1}
    assert costs.flops == 4 * B * H * limit * D
    assert costs.hbm_bytes == (2 * B * limit * Hkv * D + 2 * B * H * D) * 2
    # the split partials the launch would use, at 132 SMs, are allocated
    plan = da_ops.plan(B, H, Hkv, D, limit, H100["sm_count"])
    scratch = 0 if plan.n_split == 1 else B * H * plan.n_split * (D + 2) * 4
    assert (plan.n_split > 1) == (T > 64)
    assert costs.peak_bytes == out.numel() * 2 + scratch


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_ssd_counts_its_formula(dtype):
    B, S, nh, P, G, N, Q = 1, 128, 4, 16, 1, 16, 64
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, nh, P, generator=g).to(dtype)
    dt = torch.rand(B, S, nh, generator=g) * 0.1
    A = -torch.rand(nh, generator=g)
    Bm, Cm = (torch.randn(B, S, G, N, generator=g).to(dtype)
              for _ in range(2))
    (y, state), costs = _fake_call(lambda *a: ssd(*a, chunk=Q),
                                   (x, dt, A, Bm, Cm))
    ry, rstate = ssd(x, dt, A, Bm, Cm, chunk=Q)
    assert (y.shape, y.dtype, state.shape, state.dtype) == \
        (ry.shape, ry.dtype, rstate.shape, rstate.dtype)
    assert costs.kernel_calls == {"ssd_scan": 1}
    assert costs.flops == B * nh * (S // Q) * (Q * (Q + 1) * (N + P)
                                               + 4 * Q * N * P)
    item = x.element_size()
    assert costs.hbm_bytes == (2 * B * S * nh * P * item + B * S * nh * 4
                               + 2 * B * S * G * N * item
                               + B * nh * N * P * 4 + nh * 4)
    # bf16: the four passes' fp32 scratch is allocated, as the launch's
    outputs = y.numel() * item + state.numel() * 4
    from repro_torch.kernels.ssd_scan.ops import scratch_shapes
    scratch = sum(math.prod(s) * 4 for s in
                  scratch_shapes(B, S, nh, P, G, N, Q).values())
    assert costs.peak_bytes >= outputs + (scratch if dtype == torch.bfloat16
                                          else 0)


def test_fake_preprocess_counts_its_formula():
    images = torch.randint(0, 255, (3, 32, 32, 3), dtype=torch.uint8)
    crop, mean, std = (2, 3, 24, 20), [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
    out, costs = _fake_call(lambda x: fused_preprocess(x, crop, mean, std),
                            (images,))
    real = fused_preprocess(images, crop, mean, std)
    assert (out.shape, out.dtype) == (real.shape, real.dtype)
    n = 3 * 24 * 20 * 3
    assert costs.kernel_calls == {"fused_preprocess": 1}
    assert (costs.flops, costs.hbm_bytes) == (3 * n, 5 * n)
