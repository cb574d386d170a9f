"""The port's Word2Vec (``flinkml_tpu_torch.models.word2vec``) against the
JAX package's, on the CPU at world 1.

Every case of ``tests/test_word2vec.py`` and the Word2Vec cases of
``tests/test_stream_fit_recsys.py``, run on the port with the JAX tests'
own assertions (the JAX package's ``FLINKML_TPU_W2V_ACCUM`` is the port's
``Word2Vec(accum=...)``; its sharded-trainer cases need several ranks and
run in ``tests/test_torch_recsys_b.py``, the sharded trainer's math is
held here at one shard), plus parity with JAX on a one-device mesh:

  - the vocabulary, pairs, negative pool and initial vectors come from
    ``np.random.default_rng(seed)`` in both packages: the same bits;
  - the first 1 and 5 steps of ``_sgns_trainer`` (``scatter`` and
    ``onehot``) equal JAX's within 1e-6: the threefry draws select the
    same pairs and negatives, and on the CPU the plain ``segment_sum``
    adds in cell order as XLA's scatter does (the two ``u`` sums are added
    afterwards, so rows hit by a context and a negative round once more);
  - whole fits, in RAM and streamed, agree with JAX's within 1e-4 (SGD
    over many steps accumulates that rounding);
  - ``find_synonyms`` of a model carried across by ``stage_from_arrays``
    returns JAX's words, its scores within 1e-6; the document vectors are
    JAX's bit for bit (host float64 in both).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flinkml_tpu.models as jm
from flinkml_tpu.iteration import CheckpointManager as JCheckpointManager
from flinkml_tpu.models import word2vec as jw2v
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.io.read_write import load_stage, stage_from_arrays
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.models import Tokenizer, Word2Vec, Word2VecModel
from flinkml_tpu_torch.models import word2vec as tw2v
from flinkml_tpu_torch.ops import threefry
from flinkml_tpu_torch.parallel import DeviceMesh
from flinkml_tpu_torch.table import Table

FIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _jmesh():
    return JMesh(devices=jax.devices()[:1])


def _topic_corpus(n_docs=600, seed=0):
    """Two disjoint topics: words inside a topic co-occur, across don't."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "mouse", "bird"]
    tools = ["hammer", "wrench", "drill", "saw", "pliers"]
    docs = []
    for _ in range(n_docs):
        pool = animals if rng.uniform() < 0.5 else tools
        docs.append(" ".join(rng.choice(pool, size=8)))
    return docs, animals, tools


def _setup(w2v, **kw):
    w2v = (w2v.set_input_col("tok").set_output_col("vec").set_vector_size(16)
           .set_window_size(3).set_min_count(2).set_max_iter(10)
           .set_learning_rate(2.0).set_batch_size(512).set_seed(0))
    for name, v in kw.items():
        getattr(w2v, f"set_{name}")(v)
    return w2v


def _tokens(docs):
    (tok,) = Tokenizer().set_input_col("text").set_output_col("tok") \
        .transform(Table({"text": np.asarray(docs)}))
    return tok


def _fit(docs, accum="scatter", **kw):
    tok = _tokens(docs)
    return _setup(Word2Vec(accum=accum), **kw).fit(tok), tok


def _jax_fit(docs, **kw):
    (tok,) = jm.Tokenizer().set_input_col("text").set_output_col("tok") \
        .transform(JTable({"text": np.asarray(docs)}))
    return _setup(jm.Word2Vec(mesh=_jmesh()), **kw).fit(tok)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_topic_structure_in_embeddings():
    docs, animals, tools = _topic_corpus()
    model, _ = _fit(docs)
    vecs = {w: model.vectors[list(model.vocabulary).index(w)]
            for w in animals + tools}
    within = np.mean([_cos(vecs[a], vecs[b])
                      for a in animals for b in animals if a != b])
    across = np.mean([_cos(vecs[a], vecs[t]) for a in animals for t in tools])
    assert within > across + 0.3, (within, across)
    ref = _jax_fit(docs)
    np.testing.assert_array_equal(model.vocabulary, ref.vocabulary)
    np.testing.assert_allclose(model.vectors, ref.vectors, **FIT_TOL)


def test_find_synonyms_prefers_same_topic():
    docs, animals, tools = _topic_corpus(seed=1)
    model, _ = _fit(docs)
    words, sims = model.find_synonyms("cat", 4)
    assert "cat" not in words
    assert sum(1 for w in words if w in animals) >= 3, words
    assert np.all(np.diff(sims) <= 1e-6)
    with pytest.raises(ValueError, match="not in the vocabulary"):
        model.find_synonyms("zebra", 2)


def test_find_synonyms_of_carried_model_match_jax(tmp_path):
    docs, _, _ = _topic_corpus(seed=1)
    ref = _jax_fit(docs, max_iter=3)
    carried = stage_from_arrays(
        "flinkml_tpu.models.word2vec.Word2VecModel",
        ref.get_param_map_json(),
        {"word": ref.vocabulary, "vector": ref.vectors})
    for word in ("cat", "saw", "bird"):
        for k in (1, 4, 9, 50):
            got_w, got_s = carried.find_synonyms(word, k)
            want_w, want_s = ref.find_synonyms(word, k)
            assert list(got_w) == list(want_w), (word, k)
            np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    ref.save(str(tmp_path / "jw2v"))
    loaded = load_stage(str(tmp_path / "jw2v"))
    assert isinstance(loaded, Word2VecModel)
    tok = _tokens(docs[:20])
    (jtok,) = jm.Tokenizer().set_input_col("text").set_output_col("tok") \
        .transform(JTable({"text": np.asarray(docs[:20])}))
    assert loaded.transform(tok)[0]["vec"].tobytes() == \
        ref.transform(jtok)[0]["vec"].tobytes()


def test_doc_vectors_and_oov():
    docs, _, _ = _topic_corpus(seed=2)
    model, tok = _fit(docs)
    (out,) = model.transform(tok)
    assert out["vec"].shape == (len(docs), 16)
    (ovec,) = model.transform(_tokens(["zzz qqq"]))
    np.testing.assert_array_equal(ovec["vec"][0], np.zeros(16))


def test_min_count_prunes_and_validation():
    tok = _tokens(["a a a a b", "a a c"])
    model = (Word2Vec().set_input_col("tok").set_output_col("v")
             .set_min_count(2).set_vector_size(4).set_max_iter(1)
             .set_seed(0).fit(tok))
    assert list(model.vocabulary) == ["a"]
    with pytest.raises(ValueError, match="minCount"):
        Word2Vec().set_input_col("tok").set_output_col("v") \
            .set_min_count(100).fit(tok)


def test_persistence_and_determinism(tmp_path):
    docs, _, _ = _topic_corpus(n_docs=100, seed=3)
    model, tok = _fit(docs, max_iter=2)
    model.save(str(tmp_path / "w2v"))
    loaded = Word2VecModel.load(str(tmp_path / "w2v"))
    np.testing.assert_array_equal(loaded.vocabulary, model.vocabulary)
    (v1,) = model.transform(tok)
    (v2,) = loaded.transform(tok)
    np.testing.assert_allclose(v2["vec"], v1["vec"])
    model2, _ = _fit(docs, max_iter=2)
    np.testing.assert_array_equal(model2.vectors, model.vectors)
    jloaded = jm.Word2VecModel.load(str(tmp_path / "w2v"))
    np.testing.assert_array_equal(jloaded.vectors, model.vectors)


def test_sharded_trainer_matches_dense_at_one_shard():
    """The vocab-sharded trainer over one shard (world 1: the exchange is
    local) follows the dense trainer's draws; its vectors agree within
    the JAX test's tolerance."""
    args, v0, u0 = _trainer_inputs(vocab=40, dim=8, n=300, seed=6)
    mesh = DeviceMesh()
    dense = tw2v._sgns_trainer(None, 32, 3)(*args, v0, u0, 0.5, 20,
                                            threefry.PRNGKey(1, "cpu"))
    for strategy in ("ring", "all_to_all"):
        sharded = tw2v._sgns_trainer_sharded(mesh, 32, 3, 40, strategy)(
            *args, v0, u0, 0.5, 20, threefry.PRNGKey(1, "cpu"))
        for a, b in zip(sharded, dense):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                       atol=2e-4)


def test_onehot_accum_matches_scatter():
    docs, _, _ = _topic_corpus(seed=4)
    scatter_model, _ = _fit(docs)
    onehot_model, _ = _fit(docs, accum="onehot")
    np.testing.assert_array_equal(onehot_model.vocabulary,
                                  scatter_model.vocabulary)
    np.testing.assert_allclose(onehot_model._vectors, scatter_model._vectors,
                               rtol=2e-3, atol=2e-4)
    vec = {str(t): onehot_model._vectors[i]
           for i, t in enumerate(onehot_model._vocab)}
    assert _cos(vec["cat"], vec["dog"]) > _cos(vec["cat"], vec["hammer"])


def test_accum_keyword_rejects_unknown():
    with pytest.raises(ValueError, match="accum='bogus'"):
        Word2Vec(accum="bogus")


def test_onehot_accum_refuses_tables_off_the_cpu():
    """The one-hot operand is [bs*n_neg, vocab]: the trainer takes it for
    CPU tables only (meta tensors stand in for the card's here)."""
    args, v0, u0 = _trainer_inputs()
    trainer = tw2v._sgns_trainer(None, 64, 3, "onehot")
    with pytest.raises(ValueError, match="CPU tables only"):
        trainer(*args, v0.to("meta"), u0.to("meta"), 0.5, 1,
                threefry.PRNGKey(3, "cpu"))


def _trainer_inputs(vocab=50, dim=8, n=400, pool_n=1 << 10, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, vocab, n).astype(np.int32)
    contexts = rng.integers(0, vocab, n).astype(np.int32)
    pool = rng.integers(0, vocab, pool_n).astype(np.int32)
    v0 = ((rng.random((vocab, dim)) - 0.5) / dim).astype(np.float32)
    u0 = (rng.normal(size=(vocab, dim)) * 0.1).astype(np.float32)
    args = (torch.from_numpy(centers), torch.from_numpy(contexts),
            torch.ones(n), torch.from_numpy(pool))
    return args, torch.from_numpy(v0), torch.from_numpy(u0)


@pytest.mark.parametrize("steps", (1, 5))
@pytest.mark.parametrize("accum", tw2v.ACCUMS)
def test_sgns_first_steps_match_jax(accum, steps):
    args, v0, u0 = _trainer_inputs()
    jt = jw2v._sgns_trainer(_jmesh().mesh, "data", 64, 3, accum, "xla")
    jv, ju = jt(*(a.numpy() for a in args[:3]), jnp.asarray(args[3].numpy()),
                jnp.asarray(v0.numpy()), jnp.asarray(u0.numpy()),
                jnp.float32(0.5), jnp.int32(steps), jax.random.PRNGKey(3))
    tv, tu = tw2v._sgns_trainer(None, 64, 3, accum)(
        *args, v0, u0, 0.5, steps, threefry.PRNGKey(3, "cpu"))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-6)


def test_sgns_draws_match_jax():
    """The pair rows and pool slots of steps 0..39 are JAX's draws."""
    key = jax.random.PRNGKey(5)
    draws = tw2v.PairDraws(threefry.PRNGKey(5, "cpu"), 16, 4, 300, 1 << 18)
    for step in (0, 1, 31, 32, 39):
        k1, k2 = jax.random.split(jax.random.fold_in(key, step))
        rows, slots = draws(step)
        assert (np.asarray(jax.random.randint(k1, (16,), 0, 300))
                == rows.numpy()).all()
        assert (np.asarray(jax.random.randint(k2, (16, 4), 0, 1 << 18))
                == slots.numpy()).all()


# -- the streamed fit (tests/test_stream_fit_recsys.py's Word2Vec cases) ------

def _sentence_tables(n_batches=3, per_batch=40, seed=0, table=Table):
    rng = np.random.default_rng(seed)
    cliques = [[f"a{i}" for i in range(6)], [f"b{i}" for i in range(6)]]
    out = []
    for _ in range(n_batches):
        docs = [list(rng.choice(cliques[rng.integers(0, 2)], size=8))
                for _ in range(per_batch)]
        out.append(table({"tokens": np.asarray(docs, dtype=object)}))
    return out


def _w2v(cls=Word2Vec, **kw):
    return (cls(**kw).set_input_col("tokens").set_vector_size(16)
            .set_window_size(2).set_min_count(1).set_max_iter(3).set_seed(0))


def _crash_manager_cls(base, crash_at_epoch):
    class Crash(base):
        fired = False

        def save(self, state, epoch, extra=None, **kw):
            p = super().save(state, epoch, extra, **kw)
            if not Crash.fired and epoch >= crash_at_epoch:
                Crash.fired = True
                raise RuntimeError("injected crash")
            return p

    return Crash


def test_w2v_stream_spilled_matches_ram_exactly(tmp_path):
    ram = _w2v().fit(iter(_sentence_tables()))
    spilled = _w2v(cache_dir=str(tmp_path / "w2v"),
                   cache_memory_budget_bytes=1).fit(iter(_sentence_tables()))
    assert list(ram.vocabulary) == list(spilled.vocabulary)
    np.testing.assert_array_equal(spilled.vectors, ram.vectors)
    assert any((tmp_path / "w2v").glob("segment-*.bin"))
    ref = _w2v(jm.Word2Vec, mesh=_jmesh()).fit(
        iter(_sentence_tables(table=JTable)))
    assert list(ram.vocabulary) == list(ref.vocabulary)
    np.testing.assert_allclose(ram.vectors, ref.vectors, **FIT_TOL)


def test_w2v_stream_separates_cliques():
    model = _w2v().set_max_iter(8).fit(iter(_sentence_tables()))
    vecs = model.vectors / np.linalg.norm(model.vectors, axis=1,
                                          keepdims=True)
    idx = {t: i for i, t in enumerate(model.vocabulary)}
    assert float(vecs[idx["a0"]] @ vecs[idx["a1"]]) > \
        float(vecs[idx["a0"]] @ vecs[idx["b0"]])


def test_w2v_stream_resume_exact(tmp_path):
    golden = _w2v().set_max_iter(4).fit(iter(_sentence_tables()))
    mgr = _crash_manager_cls(CheckpointManager, 2)(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="injected"):
        _w2v(checkpoint_manager=mgr, checkpoint_interval=2).set_max_iter(4) \
            .fit(iter(_sentence_tables()))
    assert mgr.latest_epoch() == 2
    rec = _w2v(checkpoint_manager=mgr, checkpoint_interval=2,
               resume=True).set_max_iter(4).fit(iter(_sentence_tables()))
    np.testing.assert_array_equal(rec.vectors, golden.vectors)


def test_w2v_stream_resumes_a_jax_snapshot(tmp_path):
    """A JAX streamed fit's epoch-2 snapshot resumes in the port, which
    finishes within tolerance of JAX's uninterrupted run."""
    jgolden = _w2v(jm.Word2Vec, mesh=_jmesh()).set_max_iter(4).fit(
        iter(_sentence_tables(table=JTable)))
    jmgr = JCheckpointManager(str(tmp_path / "ckpt"), world_size=1)
    _w2v(jm.Word2Vec, mesh=_jmesh(), checkpoint_manager=jmgr,
         checkpoint_interval=2).set_max_iter(2).fit(
        iter(_sentence_tables(table=JTable)))
    jmgr.wait()
    rec = _w2v(checkpoint_manager=CheckpointManager(str(tmp_path / "ckpt")),
               checkpoint_interval=2, resume=True).set_max_iter(4).fit(
        iter(_sentence_tables()))
    np.testing.assert_allclose(rec.vectors, jgolden.vectors, **FIT_TOL)


def test_w2v_stream_refuses_a_data_cache():
    from flinkml_tpu_torch.iteration.datacache import cache_stream

    with pytest.raises(ValueError, match="raw DataCache"):
        _w2v().fit(cache_stream([{"c": np.zeros(3, np.int32)}]))
