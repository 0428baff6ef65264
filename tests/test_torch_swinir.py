"""SwinIR (``models/swinir.py``) and its window-attention kernel
(``ops/window_attn.py``, ``csrc/window_attn.cu``).

On the CPU, at a small size (embed 60, 2 heads of 30 as published, RSTBs of
one unshifted and one shifted block, window 8, ``3conv``, 16 tail
features), on seeded weights whose q and k give logits of a std of at least
1 and whose bias tables are N(0, 1): the port against the plain reference
``benchmark/reference/swinir.py`` in float32 (max |diff| <= 1e-4 on outputs
in [0, 1]: the two differ in the order of their sums alone) and in bfloat16
against the float32 reference in units of the reference's bfloat16
composition's gap; three faulted programs (the
scale 32^-0.5, the bias index transposed, the mask dropped) each fail the
float32 bound; ``window_attn_plain`` against SwinIR's unfused composition;
the loader on a state dict under SwinIR's names; ``SRPipeline(arch=
"swinir_l")``'s ``apply``, ``upscale`` and tiled ``upscale``; the
``inference`` CLI and the HTTP front end with ``--arch swinir_l`` on a
release-style ``.pth`` (``params_ema``).

Marked ``cuda`` (each skips without a CUDA device; this file imports no
JAX, so on the card ``python -m pytest --noconftest -m cuda
tests/test_torch_swinir.py``): the kernel against ``window_attn_plain`` at
the cell's shape and at odd padded sizes in both dtypes, and 54 launches a
SwinIR-L forward under ``no_grad`` (with the tail kernel's 3, as RRDBNet's)
and none under autograd; a tiled upscale over replicas on two cards against
one card's (skips below two).  RRDBNet's tail keeps its bits:
``tests/test_torch_tail_epilogue.py``, whose kernel SwinIR shares unchanged.
"""

import socket
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from benchmark.harness import GapRatio
from benchmark.reference import swinir as reference
from real_esrgan_tpu_torch import inference
from real_esrgan_tpu_torch.models.swinir import SwinIR
from real_esrgan_tpu_torch.ops import tail_epilogue, window_attn as wa
from real_esrgan_tpu_torch.parallel.tiling import pad_for_tiles, tile_grid
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.scripts import serve_http
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.imgio import decode_png, encode_png, read_png, write_png

SMALL = dict(embed_dim=60, depths=(2, 2), num_heads=(2, 2), num_feat=16)
CFG = dict(window_size=8, layer_norm_eps=1e-5, img_range=1.0, img_size=64, depths=[2, 2],
           num_heads=[2, 2], rgb_mean=list(reference.MEAN), upscale=4)
SHAPES = [(2, 24, 40), (1, 20, 28)]  # the second padded by the model to 24 x 32
SHAPE_IDS = ["2x24x40", "1x20x28_padded"]
F32_BOUND = 1e-4


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(4)


def small_params(seed: int = 0) -> dict:
    """The small model's state dict with the attention weighing on the
    output as a trained model's does: qkv and proj weights N(0, 0.2^2) (the
    logits' std is then about 60 x 0.2^2 = 2.4), the bias tables N(0, 1),
    every conv but the last 1.5 times its default draw, so that the convs
    pass the trunk's changes on rather than damp them."""
    gen = torch.Generator().manual_seed(seed)
    params = SwinIR(**SMALL, generator=gen).state_dict()
    for name, p in params.items():
        if name.endswith("relative_position_bias_table"):
            p.copy_(torch.randn(p.shape, generator=gen))
        elif name.endswith(("attn.qkv.weight", "attn.proj.weight")):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        elif p.dim() == 4 and not name.startswith("conv_last"):
            p.mul_(1.5)
    return params


def small_model(params: dict, dtype=torch.float32) -> SwinIR:
    model = SwinIR(**SMALL, dtype=dtype).eval()
    model.load_state_dict(params)
    return model


def inputs(shape, seed: int = 1) -> torch.Tensor:
    return torch.rand(*shape, 3, generator=torch.Generator().manual_seed(seed))


def test_logits_have_a_std_of_at_least_one():
    params = small_params()
    x = torch.randn(1, 64, SMALL["embed_dim"])
    y = torch.nn.functional.layer_norm(x, (SMALL["embed_dim"],))
    name = "layers.0.residual_group.blocks.0.attn.qkv"
    qkv = torch.nn.functional.linear(y, params[f"{name}.weight"], params[f"{name}.bias"])
    q, k = qkv[..., :30], qkv[..., 60:90]  # head 0
    assert float((q @ k.transpose(-2, -1) * 30 ** -0.5).std()) >= 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_port_matches_reference_float32(shape):
    params, x = small_params(), inputs(shape)
    with torch.no_grad():
        out = small_model(params)(x)
    ref = reference.forward_in_blocks(params, x, CFG, 2)
    assert out.shape == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    assert float((out - ref).abs().max()) <= F32_BOUND


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_port_matches_reference_bfloat16(shape):
    """The port in bfloat16 against the float32 reference, in units of the
    reference's own bfloat16 composition's gap to it (the benchmark's
    ``GapRatio``).  Both round every product's output to bfloat16 and keep
    the image's normalisation in float32; their sums differ in order and
    the port keeps LayerNorm's weights and the bias tables in float32, so
    their gaps are alike but not equal: the port's RMS gap within 1.5 times
    the composition's (it reads 0.99 here) and its largest within twice."""
    params, x = small_params(), inputs(shape)
    with torch.no_grad():
        out = small_model(params, torch.bfloat16)(x)
    ref32 = reference.forward_in_blocks(params, x, CFG, 2)
    ref16 = reference.forward_in_blocks(params, x, CFG, 2, dtype=torch.bfloat16)
    gap = GapRatio()
    gap.add(out, ref32, ref16)
    assert gap.value() <= 1.5
    assert float((out - ref32).abs().max()) <= 2 * float((ref16 - ref32).abs().max())


def _wrong_scale(monkeypatch):
    monkeypatch.setattr(wa, "scale", lambda head_dim=30: 32 ** -0.5)


def _index_transposed(monkeypatch):
    index = wa.relative_position_index
    monkeypatch.setattr(wa, "relative_position_index", lambda *a, **k: index(*a, **k).t())


def _mask_dropped(monkeypatch):
    mask = wa.shift_mask
    monkeypatch.setattr(wa, "shift_mask", lambda *a, **k: torch.zeros_like(mask(*a, **k)))


FAULTS = {"scale_32": _wrong_scale, "bias_index_transposed": _index_transposed,
          "mask_dropped": _mask_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faulted_program_fails_the_float32_bound(fault, monkeypatch):
    params, x = small_params(), inputs(SHAPES[0])
    ref = reference.forward_in_blocks(params, x, CFG, 2)
    FAULTS[fault](monkeypatch)
    with torch.no_grad():
        out = small_model(params)(x)
    assert float((out - ref).abs().max()) > F32_BOUND


def _unfused(qkv, table, heads, shift):
    """SwinIR's own composition in float32, through the reference's
    functions: roll, partition, q scaled, q k^T, the gathered bias, the mask,
    softmax, times v, reverse, roll back."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    windows = reference.window_partition(x, 8).view(-1, 64, 3, heads, c // heads)
    q, k, v = windows.permute(2, 0, 3, 1, 4)
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    bias = table[reference.relative_position_index(8).view(-1)].view(64, 64, -1)
    attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
    if shift:
        mask = reference.calculate_mask(h, w, 8, shift)
        nw = mask.shape[0]
        attn = (attn.view(-1, nw, heads, 64, 64) + mask[None, :, None]).view(-1, heads, 64, 64)
    out = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(-1, 8, 8, c)
    out = reference.window_reverse(out, 8, h, w)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


@pytest.mark.parametrize("shape,heads,shift", [((2, 16, 24), 2, 4), ((1, 8, 8), 1, 4),
                                               ((1, 24, 16), 3, 0), ((2, 16, 32), 8, 4)])
def test_window_attn_plain_matches_the_unfused_composition(shape, heads, shift):
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(*shape, 3 * 30 * heads, generator=gen)
    table = torch.randn(225, heads, generator=gen)
    ours = wa.window_attn_plain(qkv, table, heads, shift)
    torch.testing.assert_close(ours, _unfused(qkv, table, heads, shift), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wa.window_attn(qkv, table, heads, shift), ours, rtol=0, atol=0)


def test_window_attn_refuses_what_the_kernel_does_not_take():
    qkv, table = torch.zeros(1, 8, 8, 180), torch.zeros(225, 2)
    with pytest.raises(ValueError, match="multiples of 8"):
        wa.window_attn(torch.zeros(1, 12, 8, 180), table, 2, 0)
    with pytest.raises(ValueError, match="3 x 2 x 30"):
        wa.window_attn(torch.zeros(1, 8, 8, 96), table, 2, 0)
    with pytest.raises(ValueError, match="shift"):
        wa.window_attn(qkv, table, 2, 8)
    with pytest.raises(TypeError, match="float32 bias table"):
        wa.window_attn(qkv, table.double(), 2, 0)
    with pytest.raises(ValueError, match="1 to 8 heads"):
        wa.window_attn(torch.zeros(1, 8, 8, 810), torch.zeros(225, 9), 9, 0)


@pytest.mark.parametrize("key", ["params_ema", "params"])
def test_loader_reads_a_swinir_state_dict(key, tmp_path):
    params = small_params()
    saved = dict(params)
    for i, depth in enumerate(SMALL["depths"]):
        for j in range(depth):
            block = f"layers.{i}.residual_group.blocks.{j}"
            saved[f"{block}.attn.relative_position_index"] = wa.relative_position_index()
            if j % 2:
                saved[f"{block}.attn_mask"] = wa.shift_mask(64, 64, 4)
    other = {k: v + 1.0 for k, v in params.items()}
    payload = {key: saved} if key == "params" else {"params_ema": saved, "params": other}
    path = tmp_path / "swinir.pth"
    torch.save(payload, path)
    loaded = load_generator_params(str(path))
    assert sorted(loaded) == sorted(params)
    model = small_model(loaded)
    x = inputs((1, 16, 16))
    with torch.no_grad():
        assert torch.equal(model(x), small_model(params)(x))


def test_pipeline_apply_upscale_and_tiled_upscale_on_the_cpu():
    """SwinIR-L at its published widths through ``SRPipeline``: ``apply``
    is the model, ``upscale`` pads to the bucket and crops, a large image
    goes through tiles whose cores are the model's tile outputs."""
    pipe = SRPipeline(arch="swinir_l", bfloat16=False, device="cpu", bucket=8,
                      tile_threshold=16, tile=16, tile_overlap=4, tile_batch=6)
    model = pipe.model
    assert isinstance(model, SwinIR) and model.dtype == torch.float32
    image = inputs((1, 12, 8))[0].numpy()
    with torch.no_grad():
        whole = model(torch.from_numpy(np.pad(image, ((0, 4), (0, 0), (0, 0)),
                                              mode="reflect"))[None])
    np.testing.assert_array_equal(pipe.apply(torch.from_numpy(image)[None])[0].numpy(),
                                  model(torch.from_numpy(image)[None])[0].detach().numpy())
    np.testing.assert_array_equal(pipe.upscale(image), whole[0, :48, :32].numpy())

    big = inputs((1, 20, 12), seed=2)[0].numpy()
    ny, nx, core = tile_grid(20, 12, 16, 4)
    padded = torch.from_numpy(pad_for_tiles(big, 16, 4))
    with torch.no_grad():
        tiles = torch.stack([padded[i * core:i * core + 16, j * core:j * core + 16]
                             for i in range(ny) for j in range(nx)])
        sr = model(tiles)[:, 16:16 + 4 * core, 16:16 + 4 * core]
    stitched = sr.reshape(ny, nx, 4 * core, 4 * core, 3).permute(0, 2, 1, 3, 4)
    stitched = stitched.reshape(ny * 4 * core, nx * 4 * core, 3)[:80, :48]
    np.testing.assert_allclose(pipe.upscale(big), stitched.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def release_pth(tmp_path_factory):
    """SwinIR-L's seed-7 weights saved as the release file is: ``params_ema``,
    with the buffers the release carries."""
    model = SwinIR(generator=torch.Generator().manual_seed(7))
    saved = dict(model.state_dict())
    saved["layers.0.residual_group.blocks.0.attn.relative_position_index"] = \
        wa.relative_position_index()
    saved["layers.0.residual_group.blocks.1.attn_mask"] = wa.shift_mask(64, 64, 4)
    path = tmp_path_factory.mktemp("swinir") / "003_realSR_SwinIR-L_x4.pth"
    torch.save({"params_ema": saved}, path)
    return str(path), model.eval()


def _quantized(sr: np.ndarray) -> np.ndarray:
    return (np.clip(sr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def test_inference_cli_serves_swinir(release_pth, tmp_path):
    path, model = release_pth
    lr = (inputs((1, 12, 16), seed=4)[0].numpy() * 255).astype(np.uint8)
    write_png(str(tmp_path / "lr.png"), lr)
    out = str(tmp_path / "sr.png")
    inference.main(inference.build_parser().parse_args(
        ["--inputs_path", str(tmp_path / "lr.png"), "--output_path", out, "--weights_path", path,
         "--arch", "swinir_l", "--cpu"]))
    sr = read_png(out)
    with torch.no_grad():
        expected = model(torch.from_numpy(lr.astype(np.float32) / 255.0)[None])[0].numpy()
    assert sr.shape == (48, 64, 3)
    assert int(np.abs(sr.astype(int) - _quantized(expected).astype(int)).max()) <= 1


def test_http_front_end_serves_swinir(release_pth):
    path, model = release_pth
    handler = serve_http.build_app(path, bfloat16=False, warmup_size=0, device="cpu",
                                   arch="swinir_l")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        lr = (inputs((1, 10, 14), seed=5)[0].numpy() * 255).astype(np.uint8)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/upscale", data=encode_png(lr),
                                     method="POST")
        sr = decode_png(urllib.request.urlopen(req, timeout=300).read())
    finally:
        server.shutdown()
    expected = handler.pipeline_ref.upscale(lr.astype(np.float32) / 255.0)
    assert sr.shape == (40, 56, 3)
    np.testing.assert_array_equal(sr, _quantized(expected))


def test_an_unknown_arch_is_refused():
    with pytest.raises(ValueError, match="unknown arch"):
        SRPipeline(arch="hat", device="cpu")
    with pytest.raises(ValueError, match="x4"):
        SRPipeline(arch="swinir_l", upscale_factor=2, device="cpu")


# ------------------------------------------------------------------ card ---

@pytest.fixture()
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _attn_inputs(shape, heads, dtype, device, seed=0):
    """qkv whose logits have a std of about 2 at head dim 30, and an N(0, 1)
    table, as the cell's weights give."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(*shape, 3 * 30 * heads, generator=gen, device=device) * 0.6
    table = torch.randn(225, heads, generator=gen, device=device)
    return qkv.to(dtype), table


# (B, H, W, heads, shift): the cell's shape in both kinds of block; odd
# padded sides (the smallest, one window row, widths of 3 and 17 windows);
# 2 and 3 heads (a row of 360 and 540 bytes in bf16: 8- and 4-byte copies)
KERNEL_CASES = [(16, 256, 256, 8, 0), (16, 256, 256, 8, 4), (1, 8, 8, 8, 4), (1, 8, 24, 8, 4),
                (2, 40, 136, 8, 4), (3, 24, 16, 2, 4), (1, 16, 40, 3, 0), (1, 16, 40, 3, 4)]
KERNEL_IDS = ["cell", "cell_shifted", "one_window", "one_row", "odd_sides", "heads2",
              "heads3", "heads3_shifted"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=KERNEL_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_kernel_matches_plain(cuda, dtype, case):
    """Equal up to the order of sums: in float32 within 2e-5 (outputs of
    magnitude ~1); in bf16 within one bf16 ulp of the largest output, plus
    one of each value (the output and the probabilities each round once to
    bf16 on both sides, and a sum in another order can round across)."""
    b, h, w, heads, shift = case
    qkv, table = _attn_inputs((b, h, w), heads, dtype, cuda, seed=h + w + shift)
    out = wa.window_attn(qkv, table, heads, shift).float()
    ref = wa.window_attn_plain(qkv, table, heads, shift).float()
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(out, ref, rtol=2 ** -8, atol=2 ** -8 * float(ref.abs().max()))


@pytest.mark.cuda
def test_the_kernel_off_a_16_byte_boundary_matches_plain(cuda):
    qkv, table = _attn_inputs((1, 16, 16), 8, torch.bfloat16, cuda)
    base = torch.empty(qkv.numel() + 2, dtype=qkv.dtype, device=cuda)
    shifted = base[2:].view(qkv.shape)  # 4 bytes off: 4-byte copies
    shifted.copy_(qkv)
    torch.testing.assert_close(wa.window_attn(shifted, table, 8, 4),
                               wa.window_attn(qkv, table, 8, 4), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_a_swinir_forward_launches_54_and_matches_autograd(cuda, dtype):
    """SwinIR-L at its published widths: 54 kernel launches and 3 of the
    tail kernel a forward under ``no_grad``, none under autograd (the plain
    versions), and the two outputs agree as the kernels do with theirs."""
    model = SwinIR(dtype=dtype, device=cuda).eval()
    x = inputs((1, 32, 40)).to(cuda)
    wa.window_attn.launches = tail_epilogue.bias_lrelu.launches = 0
    with torch.no_grad():
        fast = model(x)
    assert (wa.window_attn.launches, tail_epilogue.bias_lrelu.launches) == (54, 3)
    x.requires_grad_(True)
    slow = model(x)
    assert (wa.window_attn.launches, tail_epilogue.bias_lrelu.launches) == (54, 3)
    atol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(fast, slow.detach(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_a_tiled_upscale_over_two_cards_matches_one(cuda, dtype):
    """SwinIR-L tiled over replicas on cuda:0 and cuda:1: the kernel also
    launches on the second card (whose shared-memory limit is its own), and
    the stitched image is one card's up to the linears' choice of algorithm
    for a half batch (within the kernel-against-autograd bounds above)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one replica on cuda:0, one on cuda:1")
    kwargs = dict(arch="swinir_l", bfloat16=dtype == torch.bfloat16, tile_threshold=48,
                  tile=48, tile_overlap=8, tile_batch=4)
    one = SRPipeline(devices=["cuda:0"], **kwargs)
    two = SRPipeline(devices=["cuda:0", "cuda:1"], **kwargs)
    two.models[1].load_state_dict(one.model.state_dict())
    two.models[0].load_state_dict(one.model.state_dict())
    image = inputs((1, 100, 76), seed=5)[0].numpy()
    expected = one.upscale(image)
    wa.window_attn.launches = 0
    got = two.upscale(image)
    torch.cuda.synchronize()
    assert wa.window_attn.launches > 0
    assert got.shape == expected.shape == (400, 304, 3)
    atol = 2e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got, expected, rtol=0, atol=atol)
