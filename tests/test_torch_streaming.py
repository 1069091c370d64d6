"""PyTorch port, streaming synthesis: the receptive field and the window
plan against the JAX package's, the pipelined stream against itself and
against a full-utterance vocode, and the pool leases of streams that end
early, at a tiny size on the CPU.

Tolerances: the depth-k stream equals the depth-1 stream bit for bit (the
pipeline reorders waiting, not arithmetic); the stream equals the JAX
package's full-utterance vocode of the same mel within 2 int16 LSB (f32
convolutions summed in another order) outside the final ``overlap`` frames,
where the full vocode sees frames past the utterance and the stream sees
silence. The stream is never held bit for bit against the JAX stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_models import one_cpu_thread  # noqa: F401 (fixtures)
from test_torch_serve_core import port_engine, port_requests, request_inputs
from test_torch_synthesis import GEN_TOPO, jax_weights  # noqa: F401

TOPOLOGIES = {
    "v1": dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
               upsample_initial_channel=512, resblock_kernel_sizes=(3, 7, 11),
               resblock_dilation_sizes=((1, 3, 5),) * 3),
    "v3": dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
               upsample_initial_channel=256, resblock_kernel_sizes=(3, 5, 7),
               resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)), resblock="2"),
    "test": dict(GEN_TOPO),
}
WINDOW = 8


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_receptive_field_matches_jax(topology):
    """The per-side receptive field from each package's generator topology."""
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_tpu.serving.streaming import receptive_field_frames as j_rf
    from speakingstyle_torch.models import hifigan as th
    from speakingstyle_torch.serving.streaming import receptive_field_frames as t_rf
    from speakingstyle_torch.serving.streaming import resolve_overlap

    topo = TOPOLOGIES[topology]
    gen = th.Generator(80, **topo)
    want = j_rf(jh.Generator(**topo))
    assert t_rf(gen) == want > 0
    assert resolve_overlap(0, gen) == want and resolve_overlap(3, gen) == 3


def test_stream_plan_matches_jax():
    """``stream_plan`` spans over a grid of lengths, windows and overlaps."""
    from speakingstyle_tpu.serving.streaming import stream_plan as j_plan
    from speakingstyle_torch.serving.streaming import stream_plan as t_plan

    for mel_len in (0, 1, 5, 8, 9, 31, 100):
        for window in (1, 3, 8, 32):
            for overlap in (0, 2, 7, 40):
                got = list(t_plan(mel_len, window, overlap))
                assert got == list(j_plan(mel_len, window, overlap))
                assert sum(e - s for s, e, _, _ in got) == max(mel_len, 0)


@pytest.fixture(scope="module")
def streamed(jax_weights, tmp_path_factory):  # noqa: F811
    """An engine over the JAX weights and its mel-only (``stream=True``)
    results for the three requests."""
    engine = port_engine(tmp_path_factory.mktemp("stream"), jax_weights)
    results = engine.run(port_requests(request_inputs(), stream=True))
    assert all(r.wav is None and r.mel_len > 0 for r in results)
    return engine, results


def _stream(engine, result, depth):
    from speakingstyle_torch.serving.streaming import receptive_field_frames, stream_wav

    overlap = receptive_field_frames(engine.vocoder)
    return list(stream_wav(engine, result, WINDOW, overlap, depth=depth))


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_stream_is_bit_equal_to_depth_one(streamed, depth):
    """Depth-k streams emit the depth-1 chunks bit for bit, chunk by chunk,
    cover ``mel_len * hop`` samples, pass every window through the quality
    gate and return every lease."""
    engine, results = streamed
    checks = engine.registry.value("serve_quality_checks_total",
                                   {"class": "default", "tier": "default", "source": "stream"})
    windows = 0
    for r in results:
        one, many = _stream(engine, r, 1), _stream(engine, r, depth)
        assert len(one) == len(many) == -(-r.mel_len // WINDOW)
        for a, b in zip(one, many):
            np.testing.assert_array_equal(a, b)
        assert sum(len(c) for c in many) == r.mel_len * engine.vocoder.hop_factor
        windows += 2 * len(one)
    assert engine.registry.value("serve_quality_checks_total", {
        "class": "default", "tier": "default", "source": "stream"}) == checks + windows
    assert engine.pool.outstanding == 0


def test_vocode_window_is_dispatch_then_collect(streamed):
    """``vocode_window`` vocodes one window synchronously: the same samples
    as ``vocode_collect(vocode_dispatch(mel))``, the lease returned."""
    engine, results = streamed
    mel = results[0].mel[:WINDOW]
    got = engine.vocode_window(mel)
    assert len(got) == len(mel) * engine.vocoder.hop_factor
    np.testing.assert_array_equal(got, engine.vocode_collect(engine.vocode_dispatch(mel)))
    assert engine.pool.outstanding == 0


def test_stream_matches_the_jax_full_utterance_vocode(streamed, jax_weights):  # noqa: F811
    """The stream against the JAX package's full-utterance vocode of the
    same mel, within 2 LSB outside the final overlap tail."""
    from speakingstyle_tpu.models import hifigan as jh
    from speakingstyle_torch.serving.streaming import receptive_field_frames

    engine, results = streamed
    _, gparams = jax_weights
    overlap = receptive_field_frames(engine.vocoder)
    hop = engine.vocoder.hop_factor
    compared = 0
    for r in results:
        wav = np.concatenate(_stream(engine, r, 2))
        mel = np.zeros((1, r.bucket.t_mel, 80), np.float32)
        mel[0, : r.mel_len] = r.mel
        with jax.default_prng_impl("threefry2x32"):
            want = jh.vocoder_infer(jh.Generator(**GEN_TOPO), gparams, jnp.asarray(mel),
                                    np.array([r.mel_len]))[0]
        keep = max(0, r.mel_len - overlap) * hop
        assert want.shape == wav.shape
        assert np.abs(wav[:keep].astype(np.int32) - want[:keep].astype(np.int32)).max(
            initial=0) <= 2
        compared += keep
    assert compared > 0


@pytest.mark.parametrize("how", ["consumer_closes", "vocoder_raise", "collect_raises"])
def test_a_stream_that_ends_early_returns_every_lease(jax_weights, tmp_path, how):  # noqa: F811
    """A consumer that stops after the first chunk, an injected
    ``vocoder_raise`` on the third window and a failing collect each leave
    no lease out; no chunk is emitted twice."""
    from speakingstyle_torch.faults import FaultPlan
    from speakingstyle_torch.serving.resilience import InjectedFault
    from speakingstyle_torch.serving.streaming import receptive_field_frames, stream_wav

    plan = FaultPlan.parse("vocoder_raise@3") if how == "vocoder_raise" else None
    engine = port_engine(tmp_path, jax_weights, fault_plan=plan)
    result = max(engine.run(port_requests(request_inputs(), stream=True)),
                 key=lambda r: r.mel_len)
    assert result.mel_len > 3 * WINDOW
    overlap = receptive_field_frames(engine.vocoder)
    gen = stream_wav(engine, result, WINDOW, overlap, depth=2)
    if how == "consumer_closes":
        first = next(gen)
        assert engine.pool.outstanding == 1  # window 2 in flight
        gen.close()
        assert len(first) == WINDOW * engine.vocoder.hop_factor
    elif how == "vocoder_raise":
        chunks = []
        with pytest.raises(InjectedFault):
            for chunk in gen:
                chunks.append(chunk)
        assert len(chunks) == 1 and engine.vocode_calls == 3
    else:
        real = engine.vocode_collect
        calls = []

        def flaky(handle):
            calls.append(handle)
            if len(calls) == 2:
                real(handle)  # the window's lease goes back as in any collect
                raise RuntimeError("collect failed")
            return real(handle)

        engine.vocode_collect = flaky
        with pytest.raises(RuntimeError, match="collect failed"):
            list(gen)
    assert engine.pool.outstanding == 0
