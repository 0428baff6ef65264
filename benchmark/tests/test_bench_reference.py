"""The plain reference agrees with the port on the CPU at a tiny size, in
float32: the generator, serving (bucket pad, crop, tiles and stitch)."""

import numpy as np
import torch

from benchmark.reference import generator as reference
from benchmark.reference.serve import serve as reference_serve
from benchmark.weights import generator_convs, generator_params
from real_esrgan_tpu_torch.models.rrdbnet import Generator
from real_esrgan_tpu_torch.serve import SRPipeline


def _port(cfg, params):
    model = Generator(num_rrdb=cfg["num_block"]).eval()
    model.load_state_dict(params)
    return model


def test_weights_cover_the_port_state_dict(tiny_config):
    params = generator_params(tiny_config, 2 ** 31 + 3, "cpu")
    state = Generator(num_rrdb=tiny_config["num_block"]).state_dict()
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in state.items()}
    dense = [n for n, _, d in generator_convs(tiny_config) if d]
    assert all(float(params[f"{n}.bias"].abs().max()) == 0 for n in dense)
    again = generator_params(tiny_config, 2 ** 31 + 3, "cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_generator_matches_port(tiny_config):
    params = generator_params(tiny_config, 7, "cpu")
    x = torch.rand(2, 12, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = reference.forward(params, x, tiny_config)
        port = _port(tiny_config, params)(x)
    assert torch.allclose(ours, port, atol=2e-5), float((ours - port).abs().max())


def test_serving_matches_port(tiny_config):
    params = generator_params(tiny_config, 11, "cpu")
    pipe = SRPipeline(num_rrdb=2, bfloat16=False, device="cpu", bucket=8, tile_threshold=24,
                      tile=20, tile_overlap=4, tile_batch=3)
    pipe.model.load_state_dict(params)
    rng = np.random.default_rng(0)
    for h, w in [(13, 21), (24, 9), (30, 41), (25, 26)]:  # bucketed, then tiled
        image = rng.random((h, w, 3), dtype=np.float32)
        ours = reference_serve(params, image, tiny_config, "cpu", bucket=8, tile_threshold=24,
                               tile=20, overlap=4)
        port = pipe.upscale(image)
        assert ours.shape == port.shape == (4 * h, 4 * w, 3)
        assert np.abs(ours - port).max() < 2e-5
