"""Port parity, the port's launch path (`ops/_build.py` `card_index`,
`Library`, `check_rc`, and `csrc/launch.cuh`), which the wrappers of all
seven kernel libraries use:

  * the checks refuse CPU, mixed-device, wrong-dtype, non-contiguous and
    misaligned inputs with their messages before any library is loaded;
  * a C entry's return code raises with the refusal's message or the CUDA
    error's;
  * a library's name hashes the shared headers;
  * the side-by-side timing tool (`tools/exp_launch_ab.py`) loads another
    tree's package beside this one and holds their outputs together;

and, on a machine with a card only: SCAN, TRI, WEIGHTS, GATHER and ENCODE,
and the CP composite, the CP train forward and backward, the flagship
composite and the table products, on a side stream and inside a captured
CUDA graph give the default stream's results, their counters moving once a
launch and not on a replay."""

import ctypes
from pathlib import Path

import pytest
import torch

from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
from mirror_nerf_tpu_torch.ops import _build, fused_cp, fused_cp_train
from mirror_nerf_tpu_torch.ops import fused_mlp_t
from mirror_nerf_tpu_torch.ops import hashgrid as hg
from mirror_nerf_tpu_torch.ops import invoke_floor as fl
from mirror_nerf_tpu_torch.ops import segment_scan as ss
from mirror_nerf_tpu_torch.ops import table_mma as tm
from mirror_nerf_tpu_torch.tools import exp_hash_inkernel, exp_int8_probe
from mirror_nerf_tpu_torch.tools import exp_launch_ab, exp_reshape_probe

LIBRARIES = {"segment_scan": ss, "hashgrid": hg, "invoke_floor": fl,
             "fused_cp_composite": fused_cp, "fused_cp_train": fused_cp_train,
             "fused_mlp_t": fused_mlp_t, "table_mma": tm}


# ------------------------------------------------------ the launch helper


def test_launch_helper_refuses_before_loading():
    """CPU, mixed-device, wrong-dtype, non-contiguous and misaligned inputs
    raise with their messages; no library is loaded (none can be here)."""
    f32 = (torch.float32,)
    cpu = torch.ones(256)
    with pytest.raises(ValueError, match="needs CUDA tensors, got x on cpu"):
        _build.card_index("segment-scan", ("x", cpu, f32, 16))
    with pytest.raises(ValueError, match="several devices"):
        _build.card_index("floor", ("x", cpu, f32, 16),
                          ("out", torch.ones(256, device="meta"), f32, 16))
    with pytest.raises(ValueError,
                       match="x: need torch.float32, got torch.float64"):
        _build.card_index("segment-scan",
                          ("x", cpu.double(), f32, 16))
    with pytest.raises(ValueError, match="need a contiguous tensor"):
        _build.card_index("segment-scan",
                          ("x", torch.ones(16, 16).t(), f32, 16))
    with pytest.raises(ValueError, match="16-B aligned"):
        _build.card_index("segment-scan", ("x", torch.ones(260)[1:], f32,
                                           16))
    # every check that failed is named, the device first
    with pytest.raises(ValueError, match="needs CUDA tensors.*idx: need "
                                         "torch.int32, got torch.int64"):
        hg.gather_rows_cuda(torch.ones(8, 2), torch.zeros(4).long())
    with pytest.raises(ValueError, match="x: need torch.float32"):
        ss.segment_prefix_cuda(torch.ones(256).double(), 64, "tri")
    with pytest.raises(ValueError, match="several devices"):
        fl.axpb_cuda(torch.ones(fl.SMALL_SHAPE),
                     torch.ones(fl.SMALL_SHAPE, device="meta"))
    with pytest.raises(ValueError, match="needs CUDA tensors, got x on cpu"):
        tm.table_mma_cuda(*_int8_case("cpu"))
    for mod in LIBRARIES.values():
        assert mod._library._lib is None


def test_on_card_dispatch():
    """Off the card the dispatch answers as before: False on the CPU, a
    raise for a mix or another device."""
    cpu = torch.ones(4)
    assert _build.on_card("x", cpu, cpu) is False
    with pytest.raises(ValueError, match="several devices"):
        _build.on_card("x", cpu, cpu.to("meta"))
    with pytest.raises(ValueError, match="no x path"):
        _build.on_card("x", cpu.to("meta"))


@pytest.mark.parametrize("mod", list(LIBRARIES.values()),
                         ids=list(LIBRARIES))
def test_entries_take_the_card_and_stream_last(mod):
    """Each C entry a wrapper declares takes the card's index (int) and the
    stream (a pointer) after its own arguments, and its source guards the
    device with them."""
    src = (_build.CSRC / f"{mod._LIB}.cu").read_text()
    assert '#include "launch.cuh"' in src
    for symbol, types in mod._library.entries.items():
        assert types[-2:] == [ctypes.c_int, ctypes.c_void_p], symbol
        assert f"int {symbol}(" in src, symbol
    assert src.count("DeviceGuard guard(device);") >= len(
        mod._library.entries)


def test_no_wrapper_switches_the_device_in_python():
    """The device switch and the stream read are the launch path's: no
    wrapper opens `torch.cuda.device` or builds a Stream object."""
    for mod in LIBRARIES.values():
        src = Path(mod.__file__).read_text()
        assert "torch.cuda.device(" not in src, mod.__name__
        assert "torch.cuda.current_stream(" not in src, mod.__name__
        assert "def _library(" not in src, mod.__name__


class _Lib:
    """A stand-in for a loaded library: its CUDA error strings."""

    @staticmethod
    def mnerf_cuda_error_string(rc):
        return f"error {rc}".encode()


def test_check_rc_messages():
    """0 passes; a refusal raises ValueError with its message (or its code
    when it has none); a CUDA error raises RuntimeError with its string."""
    _build.check_rc(_Lib, 0, "segment-scan", ss._REFUSALS)
    with pytest.raises(ValueError, match="segment-scan kernel refused its "
                                         "arguments: " + ss._REFUSALS[-2]):
        _build.check_rc(_Lib, -2, "segment-scan", ss._REFUSALS)
    with pytest.raises(ValueError, match="refused its arguments: -9"):
        _build.check_rc(_Lib, -9, "floor", fl._REFUSALS)
    with pytest.raises(RuntimeError, match="floor kernel launch failed: "
                                           "error 700"):
        _build.check_rc(_Lib, 700, "floor", fl._REFUSALS)


def test_launch_ab_loads_another_tree():
    """The timing tool imports a tree's package under another name: its
    modules are its own (own counters, own build directory), and on the CPU
    its wrappers give this tree's results."""
    root = Path(_build.__file__).resolve().parents[2]
    other = exp_launch_ab.load_other(root)
    assert other["segment_scan"] is not ss
    assert other["segment_scan"].__name__ == (
        f"{exp_launch_ab.OTHER}.ops.segment_scan")
    assert other["_build"].BUILD_DIR == _build.BUILD_DIR
    x = torch.rand(4, 128, generator=torch.Generator().manual_seed(3))
    assert torch.equal(other["segment_scan"].segment_prefix(x, 64),
                       ss.segment_prefix(x, 64))
    assert torch.equal(other["invoke_floor"].axpb(x[:1].reshape(1, 1, 128)),
                       fl.axpb(x[:1].reshape(1, 1, 128)))
    with pytest.raises(SystemExit, match="no mirror_nerf_tpu_torch"):
        exp_launch_ab.load_other(root / "tests")


def test_launch_ab_holds_the_trees_together():
    """Each this/other pair of a group is compared, to its bar: a pair that
    differs beyond it fails; the library call is not compared."""
    x = torch.rand(64)
    fns = {"scan_this": lambda: x, "scan_other": lambda: x.clone(),
           "library": lambda: -x}
    assert exp_launch_ab._agree(fns, 0.0) == 0.0
    fns["tri_this"], fns["tri_other"] = (lambda: x), (lambda: x + 1e-3)
    assert exp_launch_ab._agree(fns, 2e-3) == pytest.approx(1e-3, rel=1e-3)
    with pytest.raises(AssertionError):
        exp_launch_ab._agree(fns, 1e-4)


def test_header_change_renames_the_library(tmp_path, monkeypatch):
    """A library's name hashes the shared headers too: an edited header is
    rebuilt, never loaded stale."""
    for f in _build.CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("segment_scan")
    with open(tmp_path / "launch.cuh", "a") as f:
        f.write("\n")
    assert _build.library_path("segment_scan") != before


# --------------------------------------------------- on a card only


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _counts():
    return (ss.launches_scan, ss.launches_tri, ss.launches_weights,
            hg.launches_gather, hg.launches_encode)


def _five(x, sd, table, idx, spec, enc_table, x01):
    """SCAN, TRI, WEIGHTS, GATHER and ENCODE once each."""
    with torch.no_grad():
        return (ss.segment_prefix(x, 64, "scan"),
                ss.segment_prefix(x, 64, "tri"),
                ss.prefix_weights(sd, 128),
                hg.gather_rows(table, idx),
                hg.hashgrid_encode(enc_table, x01, spec))


@pytest.fixture
def five_inputs():
    _needs_card()
    g = torch.Generator().manual_seed(5)
    x = torch.rand((1001, 128), generator=g).cuda()
    sd = exp_reshape_probe.with_sentinel(x * 1.5, 128)
    table = torch.randn((4099, 2), generator=g).cuda()
    idx = torch.randint(-4099, 2 * 4099, (777,), generator=g,
                        dtype=torch.int32).cuda()
    spec, enc_table, x01 = exp_hash_inkernel.encode_case(3001, 4, "cuda")
    return x, sd, table, idx, spec, enc_table, x01


@pytest.mark.gpu
def test_cuda_side_stream(five_inputs):
    """On a side stream the five modes give the default stream's results,
    and each counter moves once."""
    want = _five(*five_inputs)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = _counts()
    with torch.cuda.stream(side):
        got = _five(*five_inputs)
    side.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [1] * 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_graph_capture(five_inputs):
    """Captured in a CUDA graph, the five modes replay to the default
    stream's results; the counters move at capture and not on replay."""
    want = _five(*five_inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _five(*five_inputs)  # warm on a side stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    with torch.cuda.graph(graph):
        got = _five(*five_inputs)
    at_capture = _counts()
    assert [a - b for a, b in zip(at_capture, before)] == [1] * 5
    for t in got:
        t.zero_()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert _counts() == at_capture
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _int8_case(device):
    x, tabs = exp_int8_probe.inputs(**exp_int8_probe.CPU_SIZE, seed=0,
                                    device=device)
    return x, tabs["int8"]


@pytest.fixture
def four_inputs():
    """Inputs of the four libraries that last moved onto the launch path:
    the CP
    composite (37 rays, S = 64), the CP train kernels (1000 points), the
    flagship composite (37 rays, S = 16) and the int8 table products."""
    _needs_card()
    g = torch.Generator().manual_seed(6)
    cp_field = TPUGridField(bound=2.0, grid_levels=((16, 16), (32, 8)))
    cp_params = cp_field.init(g, "cuda")
    o = (torch.randn((37, 3), generator=g) * 0.2).cuda()
    d = torch.nn.functional.normalize(torch.randn((37, 3), generator=g),
                                      dim=-1).cuda()
    z = torch.sort(torch.rand((37, 64), generator=g) * 3 + 0.1,
                   -1).values.cuda()
    x = ((torch.rand((1000, 3), generator=g) * 2 - 1) * 2).cuda()
    cots = [torch.randn(s, generator=g).cuda()
            for s in ((1000,), (1000, 15), (1000, 3))]
    mlp_field = MirrorNeRFField()
    mlp_params = mlp_field.init(g, "cuda")
    return (cp_field, cp_params, o, d, z, x, cots, mlp_field, mlp_params,
            *_int8_case("cuda"))


def _four_counts():
    return (fused_cp.launches, fused_cp_train.launches_fwd,
            fused_cp_train.launches_bwd, fused_mlp_t.launches,
            tm.launches_int8)


def _four(cp_field, cp_params, o, d, z, x, cots, mlp_field, mlp_params,
          xt, t8):
    """The CP composite, the train forward and backward, the flagship
    composite and the int8 table products once each."""
    args = fused_cp_train._param_args(cp_params)
    with torch.no_grad():
        cp = fused_cp.fused_cp_rays_composite(cp_field, cp_params, o, d, d, z)
        fwd = fused_cp_train._forward(cp_field, True, x, *args[:3],
                                      args[3:])
        bwd = fused_cp_train._backward(cp_field, True, True, x, *args[:3],
                                       args[3:], *cots)
        mlp = fused_mlp_t.fused_t_rays_composite(mlp_field, mlp_params, o,
                                                 d, d, z[:, :16])
        t = tm.table_mma(xt, t8)
    return ([cp["weights"], cp["rgb"], *fwd, mlp["weights"], mlp["rgb"], t],
            [bwd[0], bwd[1], *bwd[4]])


def _four_agree(got, want):
    """Bit for bit, but the backward's sums: atomics in another order."""
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    for g, w in zip(got[1], want[1]):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())


@pytest.mark.gpu
def test_cuda_side_stream_moved_libraries(four_inputs):
    """On a side stream the four libraries give the default stream's
    results, and each counter moves once."""
    want = _four(*four_inputs)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = _four_counts()
    with torch.cuda.stream(side):
        got = _four(*four_inputs)
    side.synchronize()
    assert [a - b for a, b in zip(_four_counts(), before)] == [1] * 5
    _four_agree(got, want)


@pytest.mark.gpu
def test_cuda_graph_capture_moved_libraries(four_inputs):
    """Captured in a CUDA graph, the four libraries replay to the default
    stream's results; the counters move at capture and not on replay."""
    want = _four(*four_inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _four(*four_inputs)  # warm on a side stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _four_counts()
    with torch.cuda.graph(graph):
        got = _four(*four_inputs)
    at_capture = _four_counts()
    assert [a - b for a, b in zip(at_capture, before)] == [1] * 5
    for group in got:
        for t in group:
            t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert _four_counts() == at_capture
    _four_agree(got, want)
