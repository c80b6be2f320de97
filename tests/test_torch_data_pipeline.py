"""The port's LM data pipeline (``repro_torch.data.synth`` and
``repro_torch.data.pipeline``) against the JAX package, on the CPU.

``synth`` caches its word list in ``_WORDS`` from the first call's seed,
so every test resets the cache in BOTH modules (``monkeypatch``) before
it draws documents.  The ETL runs through the port's ``FlareContext`` on
``device="cpu"``.  Comparisons are exact: documents, packed rows and
every batch element for element.
"""
import numpy as np
import pytest

import repro.data.synth as JS
import repro_torch.data.synth as TS
from repro.data.pipeline import LMDataPipeline as JPipe
from repro_torch.data.pipeline import LMDataPipeline, PipelineState


@pytest.fixture(autouse=True)
def fresh_words(monkeypatch):
    monkeypatch.setattr(JS, "_WORDS", None)
    monkeypatch.setattr(TS, "_WORDS", None)


def _docs(n, seed):
    return TS.generate_documents(n, seed)


@pytest.mark.parametrize("seeds", [(0, 5), (3, 1), (7, 7)])
def test_generate_documents_equal_reference(monkeypatch, seeds):
    for seed in seeds:   # the second call reuses the first call's words
        want = JS.generate_documents(40, seed)
        got = TS.generate_documents(40, seed)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert list(got[k]) == list(want[k]), (seed, k)


@pytest.mark.parametrize("seq,batch,kw", [
    (32, 4, {}), (16, 3, {"min_quality": 0.5}),
    (24, 2, {"langs": ["en", "code"]}), (2000, 2, {})])
def test_batches_equal_reference_past_the_wrap(seq, batch, kw):
    """Two epochs and then some: the epoch wrap (a batch that takes the
    next epoch's first rows) and every batch equal the reference's."""
    docs = _docs(50, 2)
    jdocs = JS.generate_documents(50, 2)
    want = JPipe.from_documents(jdocs, seq, batch, **kw)
    got = LMDataPipeline.from_documents(docs, seq, batch, device="cpu", **kw)
    np.testing.assert_array_equal(got.rows, want.rows)
    n = 2 * got.batches_per_epoch + 3
    for i in range(n):
        a, b = got.next_batch(), want.next_batch()
        for k in ("tokens", "labels"):
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
        assert got.state_dict() == want.state_dict()
    assert got.state.epoch >= 2


def test_synthetic_equals_reference():
    want = JPipe.synthetic(64, 4, n_docs=30, seed=1)
    got = LMDataPipeline.synthetic(64, 4, n_docs=30, seed=1, device="cpu")
    np.testing.assert_array_equal(got.rows, want.rows)
    for _ in range(5):
        np.testing.assert_array_equal(got.next_batch()["tokens"],
                                      want.next_batch()["tokens"])


def test_pipeline_deterministic_and_resumable():
    docs = _docs(60, 3)
    p1 = LMDataPipeline.from_documents(docs, 32, 4, device="cpu")
    p2 = LMDataPipeline.from_documents(docs, 32, 4, device="cpu")
    for _ in range(5):
        b1, b2 = p1.next_batch(), p2.next_batch()
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # resume: replay from saved state matches continued stream
    state = p1.state_dict()
    cont = [p1.next_batch()["tokens"] for _ in range(4)]
    p3 = LMDataPipeline.from_documents(docs, 32, 4, device="cpu")
    p3.load_state(state)
    replay = [p3.next_batch()["tokens"] for _ in range(4)]
    for a, b in zip(cont, replay):
        np.testing.assert_array_equal(a, b)
    assert PipelineState.from_dict(state).to_dict() == state


def test_pipeline_labels_are_shifted():
    docs = _docs(30, 1)
    p = LMDataPipeline.from_documents(docs, 16, 2, device="cpu")
    b = p.next_batch()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_flare_etl_filters():
    docs = _docs(100, 2)
    lo = LMDataPipeline.from_documents(docs, 16, 2, min_quality=0.0,
                                       device="cpu")
    hi = LMDataPipeline.from_documents(docs, 16, 2, min_quality=0.9,
                                       device="cpu")
    assert len(hi.rows) < len(lo.rows)
    # the kept documents, in row order: the reference's by hand
    keep = docs["quality"] >= 0.9
    from repro_torch.data import tokenizer
    stream = tokenizer.pack_stream(tokenizer.encode_batch(
        list(docs["text"][keep])))
    n = len(stream) // 17
    np.testing.assert_array_equal(hi.rows, stream[:n * 17].reshape(n, 17))


def test_short_stream_is_tiled():
    p = LMDataPipeline(np.arange(5, dtype=np.int32), 12, 2)
    want = JPipe(np.arange(5, dtype=np.int32), 12, 2)
    np.testing.assert_array_equal(p.rows, want.rows)
    with pytest.raises(ValueError):
        LMDataPipeline(np.zeros((2, 3), np.int32), 4, 1)
