"""CPU tests of the benchmark's frozen counts against values worked by
hand, and of the trace's reduction on a made-up trace."""
from types import SimpleNamespace

import pytest

from portbench import trace
from portbench.counts import flops, kernels, peaks


def test_flash_forward_counts_4_d_a_visible_pair_and_each_tensor_once():
    # B 1, H 2 over KH 1, S 4, D 8: 10 visible pairs a head
    c = kernels.flash_fwd(1, 2, 1, 4, 8)
    assert c["flops"] == 4 * 8 * 10 * 2 == 640
    # q and out 2·4·8 each, k and v 4·8 each, in bf16; lse 2·4 floats
    assert c["bytes"] == 2 * (64 + 64 + 32 + 32) + 4 * 8 == 416


def test_flash_backward_counts_10_d_a_visible_pair_and_each_tensor_once():
    c = kernels.flash_bwd(1, 2, 1, 4, 8)
    assert c["flops"] == 10 * 8 * 10 * 2 == 1600
    # read q, out, dout (64 each), k, v (32 each), lse (8 floats);
    # written dq (64), dk, dv (32 each)
    assert c["bytes"] == 2 * (3 * 64 + 2 * 32) + 4 * 8 + 2 * (64 + 64) == 800


@pytest.mark.parametrize("shape, bound_ms", [
    ((2, 28, 4, 2048, 128), 0.0608),     # qwen2-7b's training forward
    ((2, 48, 1, 2048, 128), None)])
def test_flash_bounds_at_training_shapes_are_set_by_operations(shape,
                                                               bound_ms):
    f = kernels.flash_fwd(*shape)
    assert f["bound_s"] == f["flops"] / peaks.BF16_FLOPS
    if bound_ms:
        assert f["bound_s"] * 1e3 == pytest.approx(bound_ms, rel=2e-3)
    b = kernels.flash_bwd(*shape)
    assert b["flops"] == 2.5 * f["flops"]


def test_scan_counts_its_inputs_and_outputs_once():
    # B 1, S 2, D 3, N 2
    f = kernels.scan_fwd(1, 2, 3, 2)
    assert f["flops"] == 7 * 12
    # x, dt (6 each), B, C (4 each), A (6) read; y (6), h_final (6) written
    assert f["bytes"] == 4 * (6 + 6 + 4 + 4 + 6 + 6 + 6) == 152
    b = kernels.scan_bwd(1, 2, 3, 2)
    assert b["flops"] == 14 * 12
    # x, dt, dy, B, C, A read; dx, ddt, dB, dC, dA written
    assert b["bytes"] == 4 * ((18 + 8 + 6) + (12 + 8 + 6)) == 232


def test_the_scan_at_the_mamba_cells_shape_is_bound_by_bytes():
    f = kernels.scan_fwd(2, 2048, 8192, 16)
    assert f["bound_s"] == f["bytes"] / peaks.HBM_BYTES
    assert f["bound_s"] * 1e3 == pytest.approx(0.1208, rel=2e-3)


def test_step_flops_leave_out_the_embedding_and_add_attention():
    cfg = {"family": "dense", "n_layers": 1, "d_model": 4, "n_heads": 2,
           "n_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab_size": 10,
           "mlp_act": "gelu"}
    # unembed 40, final norm 4, norm1 4, wq 16, wk 8, wv 8, wo 16, wi 32,
    # bi 8, wo 32, bo 4, norm2 4
    assert flops.params_without_embedding(cfg) == 176
    # 6 N D at 1 × 3 tokens, and 12 · head_dim · 6 visible pairs · 2 heads
    assert flops.step_flops(cfg, 1, 3) == 6 * 176 * 3 + 12 * 2 * 6 * 2


def test_kernel_names_are_matched_to_their_kernel():
    names = {
        "void flash_wgmma_kernel<2>(CUtensorMap, int)": "flash_fwd",
        "void flash_bwd_kernel<2>(CUtensorMap)": "flash_bwd",
        "void delta_kernel<__nv_bfloat16>(int)": "flash_bwd",
        "void ssm_scan_kernel<float, 4, true>(float const*)": "scan_fwd",
        "void ssm_scan_bwd_kernel<4>(float const*)": "scan_bwd",
        "ssm_scan_bwd_sum_kernel(float const*)": "scan_bwd",
    }
    for name, kernel in names.items():
        assert [k for k in kernels.PORT_KERNELS
                if kernels.matches(k, name)] == [kernel], name
        assert kernels.is_port_kernel(name)
    assert not kernels.is_port_kernel("sm90_xmma_gemm_bf16bf16_bf16f32")


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _ev(name, start, end, device):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def _made_up_trace(flash_records=2):
    events = [_ev("portbench.window", 0, 100, False),
              _ev("portbench.window", 0, 100, True),     # its annotation
              _ev("portbench.batch_copy", 0, 10, False),
              _ev("portbench.step_enqueue", 10, 80, False),
              _ev("portbench.loss_read", 80, 100, False),
              _ev("Memcpy HtoD", 5, 12, True),
              _ev("gemm", 15, 40, True),
              _ev("elementwise", 30, 50, True),
              _ev("gemm", 85, 95, True)]
    events += [_ev("void flash_wgmma_kernel<2>(x)", 50 + 5 * i,
                   55 + 5 * i, True) for i in range(flash_records)]
    return _Prof(events)


def test_the_trace_reduces_to_busy_time_and_named_idle_gaps():
    rec = trace.reduce(_made_up_trace(), {"flash_attention": 2}, steps=1)
    # busy: 5-12, 15-60, 85-95
    assert rec.busy_us == 7 + 45 + 10 and rec.window_us == 100
    # idle: 0-5 copying the batch, 12-15 and 60-85 enqueueing the step,
    # 95-100 reading the loss
    assert rec.breakdown["idle_gaps"] == [
        ["step_enqueue", 25e-6], ["batch_copy", 5e-6], ["loss_read", 5e-6],
        ["step_enqueue", 3e-6]]
    assert [n for n, _ in rec.breakdown["device_ops"]][0] == "gemm"
    assert trace.device_seconds(rec, "flash_fwd") == (2, 10e-6)


def test_a_trace_that_dropped_a_record_is_refused():
    with pytest.raises(RuntimeError, match="records"):
        trace.reduce(_made_up_trace(1), {"flash_attention": 2}, steps=1)


@pytest.mark.parametrize("launched", [{"flash_attention": 2}, {}])
def test_a_trace_whose_records_and_launches_disagree_is_refused(launched):
    """No record of a kernel its counter saw launched (renamed, or all
    dropped), or records of one it never saw launched."""
    records = 0 if launched else 2
    with pytest.raises(RuntimeError, match="records"):
        trace.reduce(_made_up_trace(records), launched, steps=1)
