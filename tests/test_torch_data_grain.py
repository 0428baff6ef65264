"""The port's ``GrainLoader`` (grain's contract on ``torch.utils.data``) on the
CPU: each record's crop equals the JAX ``_CropSource``'s; a batch is the
crops of its stream's record keys; the stream is deterministic, its shards
are disjoint and cover the set each pass; a mid-stream ``set_state``
continues the unbroken stream, also with worker processes; the state file
round-trips in the JAX format and refuses another epoch's state.
"""

import numpy as np
import pytest

from real_esrgan_tpu.data import grain_loader as jax_grain
from real_esrgan_tpu_torch.data import grain_loader
from real_esrgan_tpu_torch.utils.imgio import write_png

HR = 32
SHAPES = [(40, 48), (32, 32), (20, 28), (64, 40), (36, 90), (48, 48)] * 2


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("grain")
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate(SHAPES):
        write_png(str(d / f"g{i:02d}.png"), (rng.random((h, w, 3)) * 255).astype(np.uint8))
    return sorted(str(p) for p in d.iterdir())


def batches(loader, epochs=1):
    return [b.copy() for _ in range(epochs) for b in loader]


def test_each_records_crop_is_the_jax_crop_sources(files):
    """Small images (20 x 28) reflect-padded, larger ones cropped at the
    offset of default_rng((seed, key)); keys past n wrap to key % n."""
    for seed in (0, 7):
        ours = grain_loader._CropSource(files, HR, seed)
        ref = jax_grain._CropSource(files, HR, seed)
        for key in list(range(len(files))) + [len(files) + 3, 5 * len(files) + 1]:
            a, b = ours[key], ref[key]
            assert a.shape == (HR, HR, 3) and a.dtype == np.uint8
            assert np.array_equal(a, b), (seed, key)


def test_batches_are_the_crops_of_the_stream(files):
    loader = grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0, seed=5)
    assert len(loader) == 3
    got = batches(loader, epochs=2)
    source = grain_loader._CropSource(files, HR, 5)
    stream = iter(grain_loader._StreamSampler(len(files), 4, 5, 0, 1, 0))
    for b in got:
        keys = next(stream)
        assert b.shape == (4, HR, HR, 3) and b.dtype == np.uint8
        assert np.array_equal(b, np.stack([source[k] for k in keys]))
    again = batches(grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0, seed=5),
                    epochs=2)
    assert all(np.array_equal(x, y) for x, y in zip(got, again))
    other = batches(grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0,
                                             seed=6))
    assert not all(np.array_equal(x, y) for x, y in zip(got, other))


def test_each_pass_is_a_permutation_and_batches_run_across_passes():
    sampler = grain_loader._StreamSampler(10, 4, 1, 0, 1, 0)
    stream = iter(sampler)
    keys = np.concatenate([next(stream) for _ in range(5)])  # 20 records: two passes
    assert sorted(keys[:10]) == list(range(10)) and sorted(keys[10:]) == list(range(10))
    assert not np.array_equal(keys[:10], keys[10:])
    assert np.array_equal(keys[:10], sampler.shard_pass(0))


def test_shards_are_disjoint_and_cover_each_pass(files):
    per_shard = len(files) // 3
    keys = []
    for shard in range(3):
        stream = iter(grain_loader._StreamSampler(len(files), 2, 7, shard, 3, 0))
        keys.append(np.concatenate([next(stream) for _ in range(per_shard // 2)]))
    assert all(len(k) == per_shard for k in keys)
    flat = np.concatenate(keys)
    assert sorted(flat.tolist()) == list(range(len(files)))  # one pass, each record once
    # drop_remainder: 13 records over 3 shards use 12 of each pass
    assert len(grain_loader._StreamSampler(13, 2, 7, 0, 3, 0).shard_pass(0)) == 4
    loaders = [grain_loader.GrainLoader(files, batch=2, hr_size=HR, num_workers=0, seed=7,
                                        shard_id=s, num_shards=2) for s in range(2)]
    assert [len(ld) for ld in loaders] == [3, 3]  # 12 // (2 * 2)
    sums = [set(b.reshape(2, -1).sum(1).tolist()) for ld in loaders for b in ld]
    assert not (sums[0] | sums[1] | sums[2]) & (sums[3] | sums[4] | sums[5])


@pytest.mark.parametrize("workers", [0, 2])
def test_set_state_mid_stream_continues_the_unbroken_stream(files, workers):
    def make():
        # a batch the workers do not deliver within WORKER_TIMEOUT_S fails the test
        return grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=workers,
                                        seed=11)

    unbroken = make()
    full = batches(unbroken, epochs=3)
    unbroken.close()
    first = make()
    batches(first)
    it = iter(first)
    next(it)  # one batch into the second epoch
    state = first.get_state()
    first.close()
    resumed = make()
    resumed.set_state(state)
    rest = batches(resumed, epochs=2)  # each epoch takes the next len() batches
    resumed.close()
    assert len(full) == 9 and len(rest) == 6
    assert all(np.array_equal(x, y) for x, y in zip(rest, full[4:]))
    assert not np.array_equal(rest[0], full[0])


def test_set_state_refuses_another_streams_state(files):
    state = grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0,
                                     seed=1).get_state()
    other = grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0, seed=2)
    with pytest.raises(ValueError, match="another stream"):
        other.set_state(state)


def test_the_state_file_round_trips(files, tmp_path):
    loader = grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0, seed=3)
    epoch1 = batches(loader)
    grain_loader.save_loader_state(loader, str(tmp_path), epoch=1)
    path = tmp_path / "loader_state_p0.bin"
    blob = path.read_bytes()
    assert int.from_bytes(blob[:8], "little") == 1 and blob[8:] == loader.get_state()
    expected = batches(loader)
    fresh = grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0, seed=3)
    assert grain_loader.restore_loader_state(fresh, str(tmp_path), epoch=1)
    resumed = batches(fresh)
    assert all(np.array_equal(x, y) for x, y in zip(resumed, expected))
    assert not np.array_equal(resumed[0], epoch1[0])
    grain_loader.save_loader_state(loader, str(tmp_path), epoch=2, process_index=3)
    assert (tmp_path / "loader_state_p3.bin").exists()


def test_an_epoch_mismatch_warns_and_a_stateless_loader_is_a_no_op(files, tmp_path, capsys):
    loader = grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0, seed=3)
    batches(loader)
    grain_loader.save_loader_state(loader, str(tmp_path), epoch=1)
    fresh = grain_loader.GrainLoader(files, batch=4, hr_size=HR, num_workers=0, seed=3)
    assert not grain_loader.restore_loader_state(fresh, str(tmp_path), epoch=2)
    assert "different epoch" in capsys.readouterr().out
    assert not grain_loader.restore_loader_state(fresh, str(tmp_path), epoch=0)
    assert not grain_loader.restore_loader_state(fresh, str(tmp_path / "none"), epoch=1)
    assert fresh.get_state() == grain_loader.GrainLoader(
        files, batch=4, hr_size=HR, num_workers=0, seed=3).get_state()

    stateless = object()
    grain_loader.save_loader_state(stateless, str(tmp_path / "s"), epoch=1)
    assert not (tmp_path / "s").exists()
    assert not grain_loader.restore_loader_state(stateless, str(tmp_path), epoch=1)
