"""CPU tests of the plain reference: its attention and scan with their
written-out gradients against autograd of the plain formulas, and its loss
and gradients against the port's plain path (``impl="ref"``) at the cells'
architectures cut to a CPU's size."""
import pytest
import torch

from portbench.reference import ops, train as reference
from portbench.reference.ssm import SelectiveScan
from portbench.tree import flatten, nest
from portbench import weights

CELLS = ("granite-20b.train-s8k", "falcon-mamba-7b.train-s2k")


def test_blocked_attention_and_its_gradient_match_autograd(monkeypatch):
    monkeypatch.setattr(ops, "_SCORE_FLOATS", 40)     # blocks of 5 rows
    gen = torch.Generator().manual_seed(0)
    B, H, KH, S, D = 2, 6, 2, 8, 4
    q, k, v = (torch.randn(s, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for s in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D)))
    dout = torch.randn((B, H, S, D), generator=gen, dtype=torch.float64)
    got = ops.attention(q, k, v, "float32")
    g_got = torch.autograd.grad(got, (q, k, v), dout)
    kk, vv = (t.repeat_interleave(H // KH, dim=1) for t in (k, v))
    s = q @ kk.transpose(-1, -2) * D ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = torch.softmax(s, dim=-1) @ vv
    g_want = torch.autograd.grad(want, (q, k, v), dout)
    torch.testing.assert_close(got, want)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b)


def test_the_scan_and_its_gradient_match_autograd_of_the_recurrence():
    gen = torch.Generator().manual_seed(1)
    B, S, D, N = 2, 7, 3, 4
    x, dt = (torch.randn(B, S, D, generator=gen, dtype=torch.float64)
             for _ in range(2))
    dt = torch.nn.functional.softplus(dt)
    Bm, Cm = (torch.randn(B, S, N, generator=gen, dtype=torch.float64)
              for _ in range(2))
    A = -torch.rand(D, N, generator=gen, dtype=torch.float64) - 0.5
    args = [t.requires_grad_() for t in (x, dt, Bm, Cm, A)]
    dy = torch.randn(B, S, D, generator=gen, dtype=torch.float64)
    got = SelectiveScan.apply(*args)
    g_got = torch.autograd.grad(got, args, dy)
    h, ys = torch.zeros(B, D, N, dtype=torch.float64), []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    want = torch.stack(ys, dim=1)
    g_want = torch.autograd.grad(want, args, dy)
    torch.testing.assert_close(got, want)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b)


def _agree(cfg, config, mix):
    """The reference's loss and gradients and the port's plain path's, at
    the port config ``cfg`` and the configuration dict ``config``."""
    from repro_torch.models import model_module
    from portbench.traffic.train import tokens_at
    M = model_module(cfg)
    tokens = torch.as_tensor(tokens_at(mix, config["vocab_size"], 7, 0))
    params = weights.draw(config, 7, "cpu")
    (loss, _), grads = M.value_and_grad(M.make_loss_fn(cfg, impl="ref"))(
        nest(params), {"tokens": tokens, "labels": tokens})
    ref_loss, ref_grads = reference.loss_and_grads(params, tokens, tokens,
                                                   config, "float32")
    assert ref_loss == pytest.approx(loss.item(), rel=1e-5)
    grads = flatten(grads)
    assert set(grads) == set(ref_grads)
    for p, g in ref_grads.items():
        torch.testing.assert_close(grads[p], g, rtol=1e-4,
                                   atol=1e-5 * g.abs().max().item(),
                                   msg=p)


@pytest.mark.parametrize("workload", CELLS)
def test_the_references_loss_and_gradients_match_the_ports_plain_path(
        workload, tiny_cell):
    from portbench.traffic.train import port_config
    cell = tiny_cell(workload)
    _agree(port_config(cell["config"]), cell["config"], cell["traffic"])


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-14b"])
def test_the_dense_references_qkv_bias_and_qk_norm_match_the_ports(arch):
    """The dense family's options that no cell runs yet: qkv_bias
    (qwen2-7b) and qk_norm (qwen3-14b), at the port's reduced widths."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(n_layers=2, compute_dtype="float32")
    config = dataclasses.asdict(cfg)
    assert config["qkv_bias"] or config["qk_norm"]
    _agree(cfg, config, {"zipf_a": 1.3, "batch": 2, "seq": 24})


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_on_the_cpu_follows_the_reference_to_rounding(
        workload, tiny_cell):
    """Three AdamW steps of the port's train step (its plain versions on
    the CPU, float32 compute) and the reference's read as one."""
    from portbench.traffic import train
    cell = tiny_cell(workload)
    result = train.run(cell, 11, 0.1, False, "cpu", 0.0)
    assert all(v < 1e-5 for v in result["numbers"].values()), \
        result["numbers"]
