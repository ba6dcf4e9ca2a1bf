"""The port's metrics, MIDI metrics, plots and codec evaluation against
``smd_tpu``'s, on the CPU; the metric and snapshot CLIs as subprocesses.

``eval.metrics`` is a numpy and scipy copy without scikit-learn: the
moment and kernel distances and the k-NN manifold tests hold to 1e-10
relative of the JAX package's (the fractions exactly); its numpy k-means
finds what scikit-learn's does where the clusters are clear-cut and comes
within 1% of its inertia where they overlap. ``eval.midi_metrics`` holds
to 1e-12 on seeded NoteSequences, ``note_f1`` exactly; ``eval_codec``'s
batch scoring equals the JAX script's arithmetic. Then ``sample_ncsn
--compute_metrics``, ``--animate`` and ``train_ncsn --snapshot_sampling``
on tiny flagfile runs, and the figure rule where matplotlib does not
import.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans as SkKMeans
from sklearn.metrics.pairwise import euclidean_distances as sk_distances

from smd_tpu.codec import melody as jmelody
from smd_tpu.codec import note_sequence as jns
from smd_tpu.eval import metrics as jmetrics
from smd_tpu.eval import midi_metrics as jmm
from smd_tpu_torch.codec import melody
from smd_tpu_torch.codec import note_sequence as tns
from smd_tpu_torch.data import records
from smd_tpu_torch.data.synthetic import toy_distribution
from smd_tpu_torch.eval import metrics, midi_metrics, plots
from smd_tpu_torch.scripts import eval_codec

ROOT = Path(__file__).resolve().parent.parent
# float64 arithmetic of the same operations; scipy's sqrtm and numpy's BLAS
# are the same libraries on both sides.
METRIC_RTOL = 1e-10
MIDI_RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _pair(seed, n_real=160, n_fake=120, shape=(3, 4), shift=0.3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_real, *shape)),
            rng.normal(shift, 1.1, size=(n_fake, *shape)))


@pytest.mark.parametrize("shape", [(3, 4), (32,), (2,)])
def test_moment_and_kernel_distances_match_jax(shape):
    real, fake = _pair(0, shape=shape)
    # Fewer samples than dimensions: a singular covariance, sqrtm's hard
    # case.
    few_real, few_fake = _pair(1, 20, 24, shape=(40,))
    for a, b in ((real, fake), (few_real, few_fake)):
        for name in ("frechet_distance", "mmd_rbf", "mmd_polynomial"):
            ours, ref = getattr(metrics, name)(a, b), getattr(jmetrics,
                                                             name)(a, b)
            assert _rel(ours, ref) <= METRIC_RTOL, name
    assert metrics.frechet_distance(real, real) < \
        metrics.frechet_distance(real, fake)


def test_euclidean_distances_are_sklearns():
    real, fake = (x.reshape(len(x), -1) for x in _pair(2))
    np.testing.assert_array_equal(metrics.euclidean_distances(real, fake),
                                  sk_distances(real, fake))
    same = metrics.euclidean_distances(real, real)
    np.testing.assert_array_equal(same, sk_distances(real, real))
    assert (np.diag(same) == 0).all()


def test_prd_summaries_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        ref_dist = rng.dirichlet(np.ones(20))
        eval_dist = rng.dirichlet(np.ones(20) * 0.5)
        ours = metrics._prd_from_histograms(ref_dist, eval_dist)
        ref = jmetrics._prd_from_histograms(ref_dist, eval_dist)
        for a, b in zip(ours, ref):
            assert _rel(a, b) <= METRIC_RTOL
        for beta in (8.0, 1.0, 2.5):
            for a, b in zip(metrics.prd_f_beta_score(ours, beta),
                            jmetrics.prd_f_beta_score(ref, beta)):
                assert _rel(a, b) <= METRIC_RTOL
        p, r = rng.uniform(size=2)
        assert _rel(metrics.f1_score(p, r), jmetrics.f1_score(p, r)) <= \
            METRIC_RTOL


@pytest.mark.parametrize("k", [1, 3, 5])
def test_precision_recall_and_realism_match_jax(k):
    real, fake = _pair(4)
    # The fractions count the same pairs: exactly equal.
    assert metrics.precision_recall(real, fake, k) == \
        jmetrics.precision_recall(real, fake, k)
    ours = metrics.realism_scores(real, fake, k)
    ref = jmetrics.realism_scores(real, fake, k)
    assert ours.shape == ref.shape and _rel(ours, ref) <= METRIC_RTOL


def _blobs(seed, per_real=30, per_fake=20, k=20, dims=8, fake_k=15):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 50, size=(k, dims))
    real = np.concatenate([c + rng.normal(size=(per_real, dims))
                           for c in centers])
    fake = np.concatenate([c + rng.normal(size=(per_fake, dims))
                           for c in centers[:fake_k]])
    return real, fake


def test_kmeans_finds_separated_blobs_as_sklearn_does():
    """Well-separated blobs: both k-means find the true partition, so the
    PRD curve and NDB equal JAX's. The PRD sums run over the clusters in
    another order (the ids are a permutation of scikit-learn's), so they
    agree to the last few ulps; NDB counts bins and is exact."""
    real, fake = _blobs(5)
    ours = metrics.precision_recall_distribution(real, fake)
    ref = jmetrics.precision_recall_distribution(real, fake)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    assert metrics.ndb_score(real, fake, k=20) == \
        jmetrics.ndb_score(real, fake, k=20)
    km = metrics.KMeans(20, n_init=3, random_state=0).fit(real)
    truth = np.repeat(np.arange(20), 30)
    # One cluster a blob: the partition is the true one.
    pairs = set(zip(truth.tolist(), km.labels_.tolist()))
    assert len(pairs) == 20 and len({b for _, b in pairs}) == 20
    np.testing.assert_array_equal(km.predict(real), km.labels_)


@pytest.mark.parametrize("k,seed", [(8, 0), (20, 1), (50, 2)])
def test_kmeans_inertia_within_one_percent_of_sklearn(k, seed):
    x = np.random.default_rng(seed).normal(size=(1000, 16))
    ours = metrics.KMeans(k, n_init=3, random_state=seed).fit(x).inertia_
    ref = SkKMeans(k, n_init=3, random_state=seed).fit(x).inertia_
    assert abs(ours / ref - 1) < 0.01


def test_kmeans_refills_an_empty_cluster():
    x = np.concatenate([np.zeros((10, 2)), np.ones((10, 2))])
    km = metrics.KMeans(3, n_init=1, random_state=0).fit(x)
    assert np.isfinite(km.cluster_centers_).all()
    assert km.inertia_ == pytest.approx(0.0, abs=1e-12)


# -- MIDI metrics -------------------------------------------------------------

def _note_sequences(module, seed, count=4):
    """Seeded NoteSequences of ``module`` (the JAX package's or the port's
    note_sequence), the same notes in each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        ns = module.NoteSequence(tempos=[module.Tempo(qpm=120)])
        t = 0.0
        for _ in range(int(rng.integers(8, 40))):
            dur = float(rng.choice([0.125, 0.25, 0.5, 1.0]))
            ns.add_note(int(rng.integers(40, 90)), int(rng.integers(40, 120)),
                        t, t + dur * float(rng.uniform(0.5, 1.0)),
                        instrument=int(rng.integers(0, 3)))
            t += dur * float(rng.choice([0.0, 0.5, 1.0, 1.0]))
        out.append(ns)
    return out


def _assert_close(ours, ref):
    if isinstance(ref, dict):
        assert set(ours) == set(ref)
        for key in ref:
            _assert_close(ours[key], ref[key])
    elif isinstance(ref, (tuple, list)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _assert_close(a, b)
    else:
        assert np.shape(ours) == np.shape(ref)
        assert _rel(ours, ref) <= MIDI_RTOL or np.array_equal(ours, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_midi_metrics_match_jax(seed):
    ours_ns, ref_ns = (_note_sequences(m, seed) for m in (tns, jns))
    for name in ("note_density", "pitch_range", "mean_pitch", "var_pitch",
                 "mean_note_duration", "var_note_duration"):
        for a, b in zip(ours_ns, ref_ns):
            for kw in ({}, {"hop_size": 1, "frame_size": 2}):
                _assert_close(getattr(midi_metrics, name)(a, **kw),
                              getattr(jmm, name)(b, **kw))
    for a, b in zip(ours_ns, ref_ns):
        for interval in (1, 2):
            _assert_close(midi_metrics.perceptual_midi_histograms(a, interval),
                          jmm.perceptual_midi_histograms(b, interval))
            _assert_close(
                midi_metrics.perceptual_midi_statistics(a, interval, True),
                jmm.perceptual_midi_statistics(b, interval, True))
    _assert_close(midi_metrics.perceptual_similarity(*ours_ns[:2]),
                  jmm.perceptual_similarity(*ref_ns[:2]))
    _assert_close(midi_metrics.oa_consistency_variance(ours_ns),
                  jmm.oa_consistency_variance(ref_ns))
    rng = np.random.default_rng(seed)
    mu1, mu2 = rng.normal(size=(2, 50))
    var1, var2 = rng.uniform(0.1, 3, size=(2, 50))
    var2[:5] = var1[:5]   # the equal-variance branch
    _assert_close(midi_metrics.overlapping_area(mu1, mu2, var1, var2),
                  jmm.overlapping_area(mu1, mu2, var1, var2))
    # note_f1 on related sequences (one a shifted, thinned copy): exact.
    for a, b, ja, jb in zip(ours_ns, ours_ns[1:] + ours_ns[:1], ref_ns,
                            ref_ns[1:] + ref_ns[:1]):
        thin_a = tns.NoteSequence(notes=a.notes[::2], total_time=a.total_time)
        thin_ja = jns.NoteSequence(notes=ja.notes[::2],
                                   total_time=ja.total_time)
        for spq in (4, 2):
            assert midi_metrics.note_f1(a, thin_a, spq) == \
                jmm.note_f1(ja, thin_ja, spq)
            assert midi_metrics.note_f1(a, b, spq) == jmm.note_f1(ja, jb, spq)
    empty = tns.NoteSequence()
    assert midi_metrics.note_f1(empty, empty, 4) == (1.0, 1.0, 1.0)


# -- eval_codec ---------------------------------------------------------------

def _jax_scores(labels, tokens, converter, spq):
    """``scripts/eval_codec.py:91-108``'s arithmetic, its lines as they are
    there, on given tokens."""
    tok_accs, tok_np_accs, ps, rs, f1s = [], [], [], [], []
    hits = tokens == labels
    tok_accs.append(hits.mean())
    mask = labels != 0
    tok_np_accs.append((hits * mask).sum() / max(mask.sum(), 1))
    real_list = converter.from_tensors(labels)
    dec_list = converter.from_tensors(tokens)
    for real_ns, dec_ns in zip(real_list, dec_list):
        p, r, f1 = jmm.note_f1(real_ns, dec_ns, spq)
        ps.append(p)
        rs.append(r)
        f1s.append(f1)
    return tok_accs[0], tok_np_accs[0], ps, rs, f1s


def test_eval_codec_scoring_matches_jax():
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 90, size=(12, 32))
    labels[:, ::3] = 0
    # A round trip right in most places, wrong in some.
    tokens = np.where(rng.uniform(size=labels.shape) < 0.8, labels,
                      rng.integers(0, 90, size=labels.shape))
    ours = eval_codec.score_batch(labels, tokens,
                                  melody.melody_2bar_converter, 4)
    ref = _jax_scores(labels, tokens, jmelody.melody_2bar_converter, 4)
    assert ours[0] == ref[0] and ours[1] == ref[1]
    assert [list(x) for x in ours[2:]] == [list(x) for x in ref[2:]]
    assert 0 < np.mean(ours[4]) < 1


def test_eval_codec_runs_on_the_shipped_codec(tmp_path):
    from smd_tpu_torch.scripts import make_melody_corpus
    make_melody_corpus.main(["make_melody_corpus",
                             f"--output_dir={tmp_path / 'corpus'}",
                             "--n_songs=6", "--seed=3"])
    scores = eval_codec.main([
        "eval_codec", f"--input={tmp_path / 'corpus'}/*.mid",
        f"--vae_params={ROOT / 'checkpoints' / 'musicvae-melody.pkl'}",
        "--max_chunks=64", "--batch_size=32", "--device=cpu"])
    assert list(scores) == list(eval_codec.NAMES)
    assert all(0 <= v <= 1 for v in scores.values())
    # The shipped codec round-trips most of its own kind of melody.
    assert scores["token_acc"] > 0.8 and scores["note_f1"] > 0.5


# -- plots and the figure rule -------------------------------------------------

def test_plots_draw_pngs():
    png = b"\x89PNG"
    rng = np.random.default_rng(7)
    assert plots.scatter_2d(rng.normal(size=(50, 2)), scale=8)\
        .getvalue().startswith(png)
    assert plots.image_tiles(rng.normal(size=(3, 64)), shape=(8, 8))\
        .getvalue().startswith(png)
    calls = []

    def score_fn(x, sigma):
        calls.append((x.dtype, x.device.type, tuple(sigma.shape)))
        return -x / sigma ** 2
    assert plots.score_field_2d(score_fn, 0.5, scale=4, num=5,
                                device="cpu").getvalue().startswith(png)
    assert calls == [(torch.float32, "cpu", (25, 1))]
    gif = plots.animate_scatter_2d(rng.normal(size=(3, 20, 2)), fps=10)
    assert gif.getvalue().startswith(b"GIF")
    fig = metrics.prd.plot([metrics.precision_recall_distribution(
        *_pair(8, 40, 40, (2,)), num_runs=1)], ["model"])
    assert fig is not None


def _python(code):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_figures_without_matplotlib():
    """With matplotlib unimportable: the modules import, ``available`` is
    false, and the flags that ask for a figure raise ImportError naming
    the flag."""
    run = _python(
        "import sys; sys.modules['matplotlib'] = None\n"
        "from smd_tpu_torch.eval import metrics, plots\n"
        "from smd_tpu_torch import sample_ncsn\n"
        "assert not plots.available()\n"
        "for argv in (['s', '--animate', '--device=cpu'],):\n"
        "    try:\n"
        "        sample_ncsn.main(argv)\n"
        "    except ImportError as e:\n"
        "        assert '--animate' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no ImportError')\n"
        "from smd_tpu_torch.scripts import sample_audio\n"
        "try:\n"
        "    sample_audio.main(['a', '--input=x', '--device=cpu'])\n"
        "except ImportError as e:\n"
        "    assert '--include_plots' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('no ImportError')\n"
        "print('ok')\n")
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr
    # Imported alone, neither module pulls matplotlib in.
    run = _python("import sys\n"
                  "import smd_tpu_torch.eval.metrics, "
                  "smd_tpu_torch.eval.plots\n"
                  "assert 'matplotlib' not in sys.modules\n")
    assert run.returncode == 0, run.stderr


# -- the CLIs -------------------------------------------------------------------

TINY = ["--num_layers=1", "--mlp_dims=32", "--batch_size=8", "--max_steps=3",
        "--snapshot_freq=2", "--num_sigmas=12", "--device=cpu"]

# One subprocess runs the CLIs' mains one after the other (the TensorBoard
# import, ~20 s here, paid once): each flagfile trains with its shipped
# --snapshot_sampling (snapshots at steps 2 and 3), then samples with
# --compute_metrics (and, for the 2-D toy, --animate).
CLI_SCRIPT = """
import sys
from smd_tpu_torch import sample_ncsn, train_ncsn
root, tiny = sys.argv[1], sys.argv[2:]
for name, flagfile, sampling in (
        ("toy", "mixture/mixture-single-2.cfg",
         ["--ld_steps=2", "--sample_size=16", "--animate",
          "--compute_metrics"]),
        ("vae", "ncsn-mel-1seq-512.cfg",
         ["--sampling=cas", "--sample_size=40", "--compute_metrics",
          "--compute_final_only"])):
    argv = [f"--flagfile=configs/{flagfile}", f"--dataset={root}/{name}",
            f"--model_dir={root}/{name}-model", *tiny]
    train_ncsn.main(["train_ncsn", *argv, "--eval_samples=16",
                     "--ld_steps=2"])
    sample_ncsn.main(["sample_ncsn", *argv, *sampling,
                      f"--sampling_dir={root}/{name}-out"])
"""


def _write_dataset(root, width, n_train=24, n_eval=40):
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("eval", n_eval)):
        data = toy_distribution(n, rng) if width == 2 else \
            rng.normal(size=(n, width)).astype(np.float32)
        records.write_tfrecord(f"{root}/{split}-0.tfrecord", data)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    _write_dataset(root / "toy", 2)
    _write_dataset(root / "vae", 512)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run([sys.executable, "-c", CLI_SCRIPT, str(root),
                          *TINY], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return root


STATS = {"precision", "recall", "f1", "improved_precision", "improved_recall",
         "improved_f1", "realism", "frechet_dist", "mmd_rbf",
         "mmd_polynomial"}


@pytest.mark.parametrize("name", ["toy", "vae"])
def test_sample_ncsn_compute_metrics_writes_finite_stats(cli_runs, name):
    with open(cli_runs / f"{name}-out" / "metrics.json") as f:
        stats = json.load(f)
    assert set(stats) == STATS
    assert all(np.isfinite(v) for v in stats.values())
    # The reference's quirk: the returned stats are the "real" baseline's,
    # real against itself: FD 0 up to sqrtm's rounding (-3.7e-6 measured
    # for the singular 512-d covariance of 40 examples, trace ~512).
    assert abs(stats["frechet_dist"]) < 1e-3
    assert stats["improved_precision"] == 1.0


def test_sample_ncsn_animate_writes_a_gif(cli_runs):
    with open(cli_runs / "toy-out" / "animated.gif", "rb") as f:
        assert f.read(3) == b"GIF"


@pytest.mark.parametrize("name", ["toy", "vae"])
def test_train_ncsn_snapshot_sampling(cli_runs, name):
    """Snapshots at steps 2 and 3 write the ``vae`` problem's pickles,
    the Langevin samplers' per-level statistics and either problem's
    TensorBoard images."""
    model_dir = cli_runs / f"{name}-model"
    if name == "vae":
        for category in ("init", "real", "fake"):
            for step in (2, 3):
                with open(model_dir / "samples" / category / f"{step}.pkl",
                          "rb") as f:
                    samples = pickle.load(f)
                assert samples.shape == (16, 512)
                assert np.isfinite(samples).all()
    assert (model_dir / "sampling_epoch0").is_dir()
    assert (model_dir / "sampling_epoch1").is_dir()
    events = [p for p in (model_dir / "eval").iterdir()
              if p.name.startswith("events")]
    assert events and sum(p.stat().st_size for p in events) > 10_000
