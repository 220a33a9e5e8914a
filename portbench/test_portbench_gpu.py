"""Tests of the benchmark that need the card (marked ``gpu``; each skips
itself without one): the port's flash kernels at the granite cell's shape,
the published 8192-token context, against the reference's attention."""
import pytest
import torch

from portbench.reference.ops import attention


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _errors(S: int):
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(S)
    B, H, KH, D = 1, 48, 1, 128
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_()
               for shape in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D)))
    dout = torch.randn((B, H, S, D), generator=gen,
                       device="cuda").to(torch.bfloat16)
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = attention(q32, k32, v32, "float32")
    wgrads = torch.autograd.grad(want, (q32, k32, v32), dout.float())
    return {name: ((got.float() - ref).abs().max()
                   / ref.abs().max()).item()
            for name, got, ref in zip(("out", "dq", "dk", "dv"),
                                      (out, *grads), (want, *wgrads))}


@pytest.mark.gpu
def test_mqa_flash_kernels_at_8192_tokens_match_the_reference():
    """The forward and the backward at q 1×48×8192×128 over one kv head,
    causal, bf16: each output's largest error, as a share of its largest
    value, within bf16's reach and no more than twice what the same
    kernels give at 2048 tokens (a shape they have run at since they were
    written) plus 2e-3."""
    _card()
    short, long = _errors(2048), _errors(8192)
    print({"2048": short, "8192": long})
    for name in long:
        assert long[name] < 2e-2, (name, long)
        assert long[name] <= 2 * short[name] + 2e-3, (name, short, long)
