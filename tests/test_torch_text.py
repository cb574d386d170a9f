"""The port's text features (``flinkml_tpu_torch.models.text``) and NGram
against the JAX package's, on the CPU.

Every case of ``tests/test_text.py`` and the NGram case of
``tests/test_catalog_completion.py``, run on the port with the JAX test's
own assertions, and each output held against the JAX package's on the same
rows bit for bit: both packages tokenize, hash (crc32) and count in host
Python, so token lists, vocabularies, sparse indices and values, and idf
vectors are identical. The text → LR pipeline fits the port's sparse
logistic regression (``spmv`` and ``segment_sum``'s plain versions here);
its features equal JAX's bit for bit and its accuracy clears the JAX
test's margin. Models carried across by ``stage_from_arrays`` and by
``load_stage`` of a JAX save transform like JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
from sklearn.feature_extraction.text import CountVectorizer as SkCount
from sklearn.feature_extraction.text import TfidfTransformer

import flinkml_tpu.models as jm
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.io.read_write import load_stage, stage_from_arrays
from flinkml_tpu_torch.models import (
    IDF,
    CountVectorizer,
    CountVectorizerModel,
    HashingTF,
    IDFModel,
    NGram,
    RegexTokenizer,
    Tokenizer,
)
from flinkml_tpu_torch.table import Table

DOCS = [
    "the cat sat on the mat",
    "the dog ate the cat",
    "dogs and cats are friends",
    "the mat was red",
]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _same_column(got, want):
    """Two object or numeric columns equal bit for bit (SparseVectors by
    size, index and value bits; token lists by content)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if hasattr(a, "indices"):
            assert a.size() == b.size()
            np.testing.assert_array_equal(a.indices, b.indices)
            assert a.values.tobytes() == b.values.tobytes()
        elif isinstance(a, np.ndarray):
            assert a.tobytes() == np.asarray(b).tobytes()
        else:
            assert list(a) == list(b)


def _both(stage_cls, jax_cls, setup, cols, col_out):
    """``transform`` of the same stage in both packages over ``cols``."""
    (got,) = setup(stage_cls()).transform(Table(dict(cols)))
    (want,) = setup(jax_cls()).transform(JTable(dict(cols)))
    _same_column(got[col_out], want[col_out])
    return got


def _tokenized():
    (out,) = Tokenizer().set_input_col("text").set_output_col("tok") \
        .transform(Table({"text": np.asarray(DOCS)}))
    return out


def _jax_tokenized():
    (out,) = jm.Tokenizer().set_input_col("text").set_output_col("tok") \
        .transform(JTable({"text": np.asarray(DOCS)}))
    return out


def test_tokenizer_lowercase_split():
    out = _both(Tokenizer, jm.Tokenizer,
                lambda s: s.set_input_col("text").set_output_col("tok"),
                {"text": np.asarray(["Hello World", "  a  B c "])}, "tok")
    assert out["tok"][0] == ["hello", "world"]
    assert out["tok"][1] == ["a", "b", "c"]


def test_regex_tokenizer_gaps_and_tokens():
    cols = {"text": np.asarray(["foo,bar;;baz", "One-Two"])}
    gaps = _both(RegexTokenizer, jm.RegexTokenizer,
                 lambda s: s.set_input_col("text").set_output_col("tok")
                 .set_pattern(r"[,;]+"), cols, "tok")
    assert gaps["tok"][0] == ["foo", "bar", "baz"]
    toks = _both(RegexTokenizer, jm.RegexTokenizer,
                 lambda s: s.set_input_col("text").set_output_col("tok")
                 .set_pattern(r"\w+").set_gaps(False)
                 .set_to_lowercase(False), cols, "tok")
    assert toks["tok"][1] == ["One", "Two"]
    minlen = _both(RegexTokenizer, jm.RegexTokenizer,
                   lambda s: s.set_input_col("text").set_output_col("tok")
                   .set_pattern(r"\w+").set_gaps(False)
                   .set_min_token_length(4), cols, "tok")
    assert minlen["tok"][0] == []


def test_hashing_tf_counts_and_determinism():
    tokens = _tokenized()
    tf = HashingTF().set_input_col("tok").set_output_col("tf") \
        .set_num_features(64)
    (out,) = tf.transform(tokens)
    (jout,) = jm.HashingTF().set_input_col("tok").set_output_col("tf") \
        .set_num_features(64).transform(_jax_tokenized())
    _same_column(out["tf"], jout["tf"])
    v0 = out["tf"][0]
    assert v0.size() == 64
    assert 2.0 in v0.values.tolist()
    assert float(v0.values.sum()) == 6.0
    (out2,) = HashingTF().set_input_col("tok").set_output_col("tf") \
        .set_num_features(64).transform(tokens)
    assert out2["tf"][0] == v0
    (binary,) = HashingTF().set_input_col("tok").set_output_col("tf") \
        .set_num_features(64).set_binary(True).transform(tokens)
    (jbinary,) = jm.HashingTF().set_input_col("tok").set_output_col("tf") \
        .set_num_features(64).set_binary(True).transform(_jax_tokenized())
    _same_column(binary["tf"], jbinary["tf"])
    assert set(binary["tf"][0].values.tolist()) == {1.0}


def _cv_pair(**params):
    est = CountVectorizer().set_input_col("tok").set_output_col("tf")
    jest = jm.CountVectorizer().set_input_col("tok").set_output_col("tf")
    for name, value in params.items():
        getattr(est, f"set_{name}")(value)
        getattr(jest, f"set_{name}")(value)
    model, jmodel = est.fit(_tokenized()), jest.fit(_jax_tokenized())
    np.testing.assert_array_equal(model.vocabulary, jmodel.vocabulary)
    (out,) = model.transform(_tokenized())
    (jout,) = jmodel.transform(_jax_tokenized())
    _same_column(out["tf"], jout["tf"])
    return model, out


def test_count_vectorizer_matches_sklearn():
    model, out = _cv_pair()
    sk = SkCount(analyzer=str.split, lowercase=False).fit(DOCS)
    assert set(model.vocabulary.tolist()) == set(sk.get_feature_names_out())
    ref = sk.transform(DOCS).toarray()
    ours_order = {t: i for i, t in enumerate(model.vocabulary)}
    perm = [ours_order[t] for t in sk.get_feature_names_out()]
    got = np.stack([v.to_array() for v in out["tf"]])[:, perm]
    np.testing.assert_array_equal(got, ref)
    assert model.vocabulary[0] == "the"


def test_count_vectorizer_df_bounds_and_vocab_size():
    m, _ = _cv_pair(min_d_f=2.0)
    assert set(m.vocabulary.tolist()) == {"the", "cat", "mat"}
    m2, _ = _cv_pair(max_d_f=0.5)
    assert "the" not in m2.vocabulary.tolist()
    m3, _ = _cv_pair(vocabulary_size=2)
    assert len(m3.vocabulary) == 2 and m3.vocabulary[0] == "the"


def test_count_vectorizer_min_tf_and_binary():
    _, out = _cv_pair(min_t_f=2.0)
    assert out["tf"][0].values.tolist() == [2.0]
    _, bout = _cv_pair(binary=True)
    assert set(bout["tf"][0].values.tolist()) == {1.0}


def test_count_vectorizer_save_load(tmp_path):
    tokens = _tokenized()
    model = CountVectorizer().set_input_col("tok").set_output_col("tf") \
        .fit(tokens)
    model.save(str(tmp_path / "cv"))
    loaded = CountVectorizerModel.load(str(tmp_path / "cv"))
    np.testing.assert_array_equal(loaded.vocabulary, model.vocabulary)
    assert loaded.transform(tokens)[0]["tf"][2] == \
        model.transform(tokens)[0]["tf"][2]
    # Across packages: a JAX save loads in the port and the reverse.
    jmodel = jm.CountVectorizer().set_input_col("tok").set_output_col("tf") \
        .fit(_jax_tokenized())
    jmodel.save(str(tmp_path / "jcv"))
    ported = load_stage(str(tmp_path / "jcv"))
    assert isinstance(ported, CountVectorizerModel)
    _same_column(ported.transform(tokens)[0]["tf"],
                 jmodel.transform(_jax_tokenized())[0]["tf"])
    back = jm.CountVectorizerModel.load(str(tmp_path / "cv"))
    np.testing.assert_array_equal(back.vocabulary, model.vocabulary)


def test_idf_matches_sklearn_formula(tmp_path):
    tokens = _tokenized()
    cv = CountVectorizer().set_input_col("tok").set_output_col("tf") \
        .fit(tokens)
    (tf_table,) = cv.transform(tokens)
    idf_model = IDF().set_input_col("tf").set_output_col("tfidf") \
        .fit(tf_table)
    jcv = jm.CountVectorizer().set_input_col("tok").set_output_col("tf") \
        .fit(_jax_tokenized())
    (jtf,) = jcv.transform(_jax_tokenized())
    jidf = jm.IDF().set_input_col("tf").set_output_col("tfidf").fit(jtf)
    assert idf_model.idf.tobytes() == jidf.idf.tobytes()
    sk = SkCount(analyzer=str.split, lowercase=False).fit(DOCS)
    counts = sk.transform(DOCS)
    sk_idf = TfidfTransformer(smooth_idf=True, norm=None).fit(counts) \
        .idf_ - 1.0
    ours_order = {t: i for i, t in enumerate(cv.vocabulary)}
    perm = [ours_order[t] for t in sk.get_feature_names_out()]
    np.testing.assert_allclose(idf_model.idf[perm], sk_idf, rtol=1e-12)
    (out,) = idf_model.transform(tf_table)
    _same_column(out["tfidf"], jidf.transform(jtf)[0]["tfidf"])
    got = np.stack([v.to_array() for v in out["tfidf"]])[:, perm]
    np.testing.assert_allclose(got, counts.toarray() * sk_idf, rtol=1e-12)
    idf_model.save(str(tmp_path / "idf"))
    loaded = IDFModel.load(str(tmp_path / "idf"))
    np.testing.assert_array_equal(loaded.idf, idf_model.idf)
    # The JAX model's arrays build the port's model.
    carried = stage_from_arrays(
        "flinkml_tpu.models.text.IDFModel", jidf.get_param_map_json(),
        {"idf": jidf.idf, "docFreq": jidf.get_model_data()[0]["docFreq"]})
    _same_column(carried.transform(tf_table)[0]["tfidf"],
                 out["tfidf"])


def test_idf_min_doc_freq_and_dense_input():
    x = np.asarray([[1.0, 0.0, 3.0], [2.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    model = IDF().set_input_col("tf").set_output_col("o") \
        .set_min_doc_freq(2).fit(Table({"tf": x}))
    jmodel = jm.IDF().set_input_col("tf").set_output_col("o") \
        .set_min_doc_freq(2).fit(JTable({"tf": x}))
    assert model.idf.tobytes() == jmodel.idf.tobytes()
    assert model.idf[1] == 0.0 and model.idf[2] == 0.0 and model.idf[0] > 0
    (out,) = model.transform(Table({"tf": x}))
    np.testing.assert_allclose(out["o"][:, 1:], 0.0)
    assert out["o"].tobytes() == \
        jmodel.transform(JTable({"tf": x}))[0]["o"].tobytes()


def _sentiment_docs():
    rng = np.random.default_rng(0)
    pos_words = ["good", "great", "excellent", "love"]
    neg_words = ["bad", "awful", "terrible", "hate"]
    filler = ["the", "movie", "was", "a", "film", "it"]
    docs, labels = [], []
    for _ in range(120):
        y = rng.integers(0, 2)
        pool = pos_words if y else neg_words
        words = list(rng.choice(pool, 3)) + list(rng.choice(filler, 4))
        rng.shuffle(words)
        docs.append(" ".join(words))
        labels.append(float(y))
    return np.asarray(docs), np.asarray(labels)


def test_text_pipeline_trains_sparse_lr():
    from flinkml_tpu.pipeline import Pipeline as JPipeline
    from flinkml_tpu_torch.models import LogisticRegression
    from flinkml_tpu_torch.pipeline import Pipeline

    docs, labels = _sentiment_docs()
    t = Table({"text": docs, "label": labels})
    pipe = Pipeline([
        Tokenizer().set_input_col("text").set_output_col("tok"),
        HashingTF().set_input_col("tok").set_output_col("features")
        .set_num_features(256),
        LogisticRegression().set_max_iter(60).set_global_batch_size(120)
        .set_learning_rate(1.0).set_seed(0),
    ])
    pm = pipe.fit(t)
    (pred,) = pm.transform(t)
    assert (pred["prediction"] == t["label"]).mean() > 0.95
    # The features the fit saw are JAX's bit for bit.
    jpipe = JPipeline([
        jm.Tokenizer().set_input_col("text").set_output_col("tok"),
        jm.HashingTF().set_input_col("tok").set_output_col("features")
        .set_num_features(256),
    ])
    (jfeat,) = jpipe.fit(JTable({"text": docs})).transform(
        JTable({"text": docs}))
    _same_column(pred["features"], jfeat["features"])


def test_hashing_tf_num_features_change_rehashes():
    tokens = _tokenized()
    tf = HashingTF().set_input_col("tok").set_output_col("tf")
    (big,) = tf.set_num_features(1024).transform(tokens)
    (small,) = tf.set_num_features(8).transform(tokens)
    for v in small["tf"]:
        assert v.size() == 8
        assert v.indices.max(initial=0) < 8
    assert big["tf"][0].size() == 1024
    (jsmall,) = jm.HashingTF().set_input_col("tok").set_output_col("tf") \
        .set_num_features(8).transform(_jax_tokenized())
    _same_column(small["tf"], jsmall["tf"])


def test_ngram_bigrams_and_short_rows():
    cols = {"text": np.asarray(["a b c d", "x y", "solo"])}
    (tok,) = Tokenizer().set_input_col("text").set_output_col("tok") \
        .transform(Table(cols))
    (jtok,) = jm.Tokenizer().set_input_col("text").set_output_col("tok") \
        .transform(JTable(cols))
    (out,) = NGram().set_input_col("tok").set_output_col("ng").transform(tok)
    (jout,) = jm.NGram().set_input_col("tok").set_output_col("ng") \
        .transform(jtok)
    _same_column(out["ng"], jout["ng"])
    assert out["ng"][0] == ["a b", "b c", "c d"]
    assert out["ng"][1] == ["x y"]
    assert out["ng"][2] == []
    (tri,) = NGram().set_n(3).set_input_col("tok").set_output_col("ng") \
        .transform(tok)
    assert tri["ng"][0] == ["a b c", "b c d"]
