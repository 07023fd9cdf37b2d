"""The port's gap-only PCM16 transport (``runtime/transport.py``) against the
JAX package's on the CPU, and the wire contract on its own.

Tolerances: the patch is int16.  The port's and JAX's restored waveforms
differ by the f32 rounding of two libraries (``tests/test_torch_gan_inference.py``:
2e-5 at most, 0.66 LSB), so a sample that lies near a rounding boundary may
land one level apart: those are counted, and must be at most 1 LSB and at
most 1 % of the samples (0 seen).  Under ``impaired`` the two packages'
patches differ by the recorded zero-bin phase rule (up to 38 LSB inside the
gap here), so each is held to the rebuild from JAX's generator output
under its own rule.  ``start`` exactly.  The host composite
equals a full-clip ``to_pcm16`` fetch of the same device-side composite
exactly, int16 for int16, in each package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.runtime.inference import make_gan_inpaint_fn as jax_make_fn
from ml_audio_inpainting_tpu.runtime.transport import composite_gap_patch as jax_composite
from ml_audio_inpainting_tpu.runtime.transport import (
    composite_gap_patches_1d as jax_composite_1d,
)
from ml_audio_inpainting_tpu.runtime.transport import make_gap_transport_fn as jax_transport
from ml_audio_inpainting_torch.ops.gaps import gap_mask
from ml_audio_inpainting_torch.ops.pcm import to_pcm16
from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn
from ml_audio_inpainting_torch.runtime.serve import make_gan_runner
from ml_audio_inpainting_torch.runtime.transport import (
    DEFAULT_PATCH_WINDOW,
    composite_gap_patch,
    composite_gap_patches_1d,
    make_gap_transport_fn,
)

from test_torch_gan_inference import (
    CKPT,
    GAP_LEN,
    GAP_START,
    _clips,
    _configs,
    _impaired_rebuild,
    _tiny,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

WINDOW = 2048


def _full_fetch(inpaint_fn, audio, starts, lens):
    """The full-clip deliverable: ``to_pcm16`` of the restored clip under the
    time composite."""
    restored, _ = inpaint_fn(audio, starts, lens)
    tmask = gap_mask(audio.shape[-1], starts, lens)
    return to_pcm16(audio * tmask + restored * (1.0 - tmask)).numpy()


@pytest.mark.parametrize("mode,phase", [("enhanced", "oracle"), ("parity", "oracle"),
                                        ("enhanced", "impaired")])
def test_patch_matches_jax(mode, phase):
    jcfg, cfg, jgen, variables, gen = _tiny()
    audio = _clips()
    want_patch, want_start = jax_transport(jax_make_fn(jcfg, jgen, mode=mode, phase=phase), WINDOW)(
        variables, jnp.asarray(audio), jnp.asarray(GAP_START), jnp.asarray(GAP_LEN))
    patch, start = make_gap_transport_fn(make_gan_inpaint_fn(cfg, gen, mode=mode, phase=phase),
                                         WINDOW)(torch.tensor(audio), torch.tensor(GAP_START),
                                                 torch.tensor(GAP_LEN))
    assert patch.dtype == torch.int16 and patch.shape == (4, WINDOW)
    assert start.dtype == torch.int32
    np.testing.assert_array_equal(start.numpy(), np.asarray(want_start))
    np.testing.assert_array_equal(start.numpy(), np.clip(GAP_START, 0, 16000 - WINDOW))
    pairs = [(patch.numpy(), np.asarray(want_patch))]
    if phase == "impaired":
        # the recorded zero-bin phase rule: each package's patch against the
        # rebuild from JAX's generator output under its own rule
        generated = np.asarray(jax_make_fn(jcfg, jgen, mode=mode, phase=phase)(
            variables, jnp.asarray(audio), jnp.asarray(GAP_START), jnp.asarray(GAP_LEN))[1])
        rows = np.arange(4)[:, None]
        cols = start.numpy()[:, None] + np.arange(WINDOW)
        pairs = [(got, to_pcm16(torch.tensor(_impaired_rebuild(audio, generated, rule))).numpy()
                  [rows, cols]) for got, rule in ((pairs[0][0], False), (pairs[0][1], True))]
    for got, want in pairs:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, f"patches differ by up to {diff.max()} LSB"
        assert np.count_nonzero(diff) <= 0.01 * diff.size, f"{np.count_nonzero(diff)} samples 1 LSB apart"


@pytest.mark.parametrize("phase", ["oracle", "impaired"])
def test_host_composite_equals_full_clip_fetch(phase):
    """``composite_gap_patch`` of the payload equals ``to_pcm16`` of the whole
    composited clip, int16 for int16, and equals the input's PCM16 outside
    the gap; the JAX package's host composite gives the same."""
    jcfg, cfg, jgen, variables, gen = _tiny()
    audio = torch.tensor(_clips())
    starts, lens = torch.tensor(GAP_START), torch.tensor(GAP_LEN)
    fn = make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase=phase)
    patch, start = make_gap_transport_fn(fn, WINDOW)(audio, starts, lens)
    client = to_pcm16(audio).numpy()
    got = composite_gap_patch(client, patch.numpy(), start.numpy())
    full = _full_fetch(fn, audio, starts, lens)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(jax_composite(client, patch.numpy(), start.numpy()), got)
    idx = np.arange(audio.shape[-1])
    outside = (idx < GAP_START[:, None]) | (idx >= (GAP_START + GAP_LEN)[:, None])
    np.testing.assert_array_equal(got[outside], client[outside])
    assert not np.array_equal(got[~outside], client[~outside])


@pytest.mark.parametrize("start,length", [(16000 - 700, 700), (16000 - WINDOW, WINDOW),
                                          (0, 100), (15999, 1)])
def test_patch_at_the_clips_edges(start, length):
    """A gap at the clip's end (or start) clamps the window inside the clip
    and still covers the gap."""
    jcfg, cfg, jgen, variables, gen = _tiny()
    audio = torch.tensor(_clips(1))
    fn = make_gan_inpaint_fn(cfg, gen, mode="enhanced")
    s, n = torch.tensor([start]), torch.tensor([length])
    patch, got_start = make_gap_transport_fn(fn, WINDOW)(audio, s, n)
    want_start = min(max(start, 0), 16000 - WINDOW)
    assert got_start.tolist() == [want_start]
    assert want_start <= start and start + length <= want_start + WINDOW
    full = _full_fetch(fn, audio, s, n)
    np.testing.assert_array_equal(patch.numpy()[0], full[0, want_start : want_start + WINDOW])
    np.testing.assert_array_equal(composite_gap_patch(to_pcm16(audio).numpy(), patch.numpy(),
                                                      got_start.numpy()), full)


def test_window_longer_than_the_clip_raises():
    jcfg, cfg, jgen, variables, gen = _tiny()
    fn = make_gap_transport_fn(make_gan_inpaint_fn(cfg, gen), 16001)
    with pytest.raises(ValueError, match="exceeds clip length"):
        fn(torch.tensor(_clips(1)), torch.tensor([100]), torch.tensor([100]))


def test_composite_gap_patches_1d_matches_jax():
    rng = np.random.default_rng(3)
    signal = rng.integers(-32768, 32767, 20000).astype(np.int16)
    patches = rng.integers(-32768, 32767, (3, 512)).astype(np.int16)
    patches[1, :100] = patches[0, -100:]  # overlapping windows agree where they overlap
    starts = np.array([1000, 1412, 19488])
    before = signal.copy()
    got = composite_gap_patches_1d(signal, patches, starts)
    np.testing.assert_array_equal(got, jax_composite_1d(signal, patches, starts))
    np.testing.assert_array_equal(got[1000:1512], patches[0])
    np.testing.assert_array_equal(got[:1000], signal[:1000])
    np.testing.assert_array_equal(signal, before)  # the client's copy is left as it was


def test_runner_returns_the_transport_payload():
    """``make_gan_runner(..., transport_window=)`` answers with ``(patch,
    start)``, the transport of its own un-transported function."""
    _, cfg = _configs(tiny=False)
    audio = _clips(1, 0.5)
    runner = make_gan_runner(cfg, CKPT, device="cpu", transport_window=DEFAULT_PATCH_WINDOW)
    patch, start = runner(audio, [2000], [1280])
    assert patch.shape == (1, DEFAULT_PATCH_WINDOW) and patch.dtype == torch.int16
    want_patch, want_start = make_gap_transport_fn(runner.inpaint_fn)(
        torch.tensor(audio), torch.tensor([2000]), torch.tensor([1280]))
    torch.testing.assert_close(patch, want_patch, rtol=0, atol=0)
    assert start.tolist() == want_start.tolist() == [2000]
    assert DEFAULT_PATCH_WINDOW == 2048
