"""Distributional evaluation metrics for latent-space samples (a numpy and
scipy copy of ``smd_tpu/eval/metrics.py``, without scikit-learn).

Parity with the reference's ``utils/metrics.py:24-77`` (Fréchet distance with
its undefined-``eps`` bug fixed, MMD-RBF, MMD-polynomial) plus full
implementations of the seven functions the reference calls but never defines
(``sample_ncsn.py:114-160``; SURVEY.md §7 item 5):

- ``precision_recall_distribution`` + ``prd.plot`` — PRD curves via k-means
  histograms (Sajjadi et al., 2018, "Assessing Generative Models via
  Precision and Recall").
- ``prd_f_beta_score`` — (F_beta, F_1/beta) summary of a PRD curve.
- ``f1_score`` — harmonic mean.
- ``precision_recall`` — improved precision & recall via k-NN manifold
  estimation (Kynkäänniemi et al., 2019).
- ``realism_scores`` — per-sample realism R(x) from the same paper.
- ``ndb_score`` — Number of statistically-Different Bins over k-means cells
  (Richardson & Weiss, 2018).

All metrics accept inputs of shape [N, *dims] and flatten trailing dims (the
reference would have crashed on its own [N, 32, 42] sequence arrays).

The JAX package computes its kernels, distances and k-means with
scikit-learn, which the port does not need: ``euclidean_distances``,
``rbf_kernel`` and ``polynomial_kernel`` here are scikit-learn's float64
arithmetic, operation for operation (``sqrt(max(|x|^2 - 2 x.y + |y|^2,
0))``, an exact-zero diagonal when X is Y), so the k-NN radii and the
``d <= radius`` tests fall on the same pairs; ``KMeans`` is a numpy Lloyd's
algorithm with k-means++ seeding (``n_init`` restarts, scikit-learn's
default tolerance, seeded by ``random_state``), whose draws are not
scikit-learn's: where the clustering is not clear-cut, the PRD curves and
NDB bins differ from the JAX package's by another local optimum.
"""
from __future__ import annotations

import types

import numpy as np
import scipy.linalg
import scipy.special

__all__ = [
    "frechet_distance", "mmd_rbf", "mmd_polynomial",
    "precision_recall_distribution", "prd", "prd_f_beta_score", "f1_score",
    "precision_recall", "realism_scores", "ndb_score", "KMeans",
    "euclidean_distances",
]


def _flat(x):
    x = np.asarray(x, dtype=np.float64)
    return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# Pairwise distances and kernels (scikit-learn's float64 arithmetic)
# ---------------------------------------------------------------------------

def _row_norms(X):
    return np.einsum("ij,ij->i", X, X)


def euclidean_distances(X, Y, squared=False, x_norms=None, y_norms=None):
    """Pairwise distances of the rows of float64 ``X`` and ``Y``,
    ``sklearn.metrics.pairwise.euclidean_distances``' arithmetic: -2 X.Y^T,
    plus |x|^2, plus |y|^2, clipped at 0, the diagonal set to exactly 0 when
    ``Y is X``, then the root unless ``squared``. ``x_norms`` and
    ``y_norms`` are the rows' squared norms where the caller has them."""
    xx = (_row_norms(X) if x_norms is None else x_norms)[:, None]
    yy = xx.T if Y is X else \
        (_row_norms(Y) if y_norms is None else y_norms)[None, :]
    d = -2 * (X @ Y.T)
    d += xx
    d += yy
    np.maximum(d, 0, out=d)
    if Y is X:
        np.fill_diagonal(d, 0)
    return d if squared else np.sqrt(d, out=d)


def _rbf_kernel(X, Y, gamma):
    K = euclidean_distances(X, Y, squared=True)
    K *= -gamma
    return np.exp(K, out=K)


def _polynomial_kernel(X, Y, degree, gamma, coef0):
    K = X @ Y.T
    K *= gamma
    K += coef0
    K **= degree
    return K


# ---------------------------------------------------------------------------
# k-means (in place of sklearn.cluster.KMeans)
# ---------------------------------------------------------------------------

class KMeans:
    """Lloyd's k-means with k-means++ seeding, scikit-learn's defaults.

    ``fit`` centers the data, then runs ``n_init`` seedings from
    ``np.random.RandomState(random_state)``: k-means++ with ``2 +
    int(log(k))`` candidates a center, then Lloyd iterations until the
    labels stop changing or the centers move by at most ``tol`` times the
    mean feature variance (squared shift, summed), at most ``max_iter``; a
    cluster left empty takes the point farthest from its center. The run of
    least inertia is kept (``cluster_centers_``, ``labels_``,
    ``inertia_``).
    """

    def __init__(self, n_clusters=8, n_init=3, max_iter=300, tol=1e-4,
                 random_state=None):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

    @staticmethod
    def _assign(X, centers, x_norms=None):
        d = euclidean_distances(X, centers, squared=True, x_norms=x_norms)
        labels = d.argmin(axis=1)
        return labels, d[np.arange(len(X)), labels]

    @staticmethod
    def _sums(X, labels, k):
        """Each cluster's sum of points: a one-hot product (BLAS), not a
        scatter-add."""
        onehot = np.zeros((k, len(X)))
        onehot[labels, np.arange(len(X))] = 1.0
        return onehot @ X

    def _seed(self, X, rng, norms):
        n, k = len(X), self.n_clusters
        trials = 2 + int(np.log(k))
        ids = [rng.randint(n)]
        closest = euclidean_distances(X[ids], X, squared=True,
                                      x_norms=norms[ids], y_norms=norms)[0]
        pot = closest.sum()
        for _ in range(1, k):
            cand = np.searchsorted(np.cumsum(closest),
                                   rng.uniform(size=trials) * pot)
            cand = np.minimum(cand, n - 1)
            d = np.minimum(closest, euclidean_distances(
                X[cand], X, squared=True, x_norms=norms[cand],
                y_norms=norms))
            pots = d.sum(axis=1)
            best = int(np.argmin(pots))
            closest, pot = d[best], pots[best]
            ids.append(int(cand[best]))
        return X[ids].copy()

    def _lloyd(self, X, centers, tol, norms):
        k = self.n_clusters
        labels_old = None
        for _ in range(self.max_iter):
            labels, dist = self._assign(X, centers, norms)
            new = self._sums(X, labels, k)
            counts = np.bincount(labels, minlength=k)
            empty = np.flatnonzero(counts == 0)
            if len(empty):
                far = np.argsort(-dist, kind="stable")[:len(empty)]
                for c, i in zip(empty, far):
                    new[c], counts[c] = X[i], 1
            new /= counts[:, None]
            shift = ((new - centers) ** 2).sum()
            centers = new
            if labels_old is not None and np.array_equal(labels,
                                                         labels_old):
                break
            if shift <= tol:
                break
            labels_old = labels
        labels, dist = self._assign(X, centers, norms)
        return centers, labels, float(dist.sum())

    def fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        mean = X.mean(axis=0)
        Xc = X - mean
        tol = float(np.mean(np.var(X, axis=0)) * self.tol)
        rng = np.random.RandomState(self.random_state)
        norms = _row_norms(Xc)
        best = None
        for _ in range(self.n_init):
            run = self._lloyd(Xc, self._seed(Xc, rng, norms), tol, norms)
            if best is None or run[2] < best[2]:
                best = run
        centers, self.labels_, self.inertia_ = best
        self.cluster_centers_ = centers + mean
        return self

    def predict(self, X):
        return self._assign(np.asarray(X, dtype=np.float64),
                            self.cluster_centers_)[0]


# ---------------------------------------------------------------------------
# Moment/kernel distances (reference utils/metrics.py:24-77)
# ---------------------------------------------------------------------------

def frechet_distance(real, fake, eps=1e-6):
    """Fréchet distance between Gaussian fits of real and fake samples."""
    real, fake = _flat(real), _flat(fake)
    mu1, sigma1 = np.mean(real, axis=0), np.cov(real, rowvar=False)
    mu2, sigma2 = np.mean(fake, axis=0), np.cov(fake, rowvar=False)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))

    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))

    if np.iscomplexobj(covmean):
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) -
                 2 * np.trace(covmean))


def mmd_rbf(real, fake, gamma=1.0):
    real, fake = _flat(real), _flat(fake)
    XX = _rbf_kernel(real, real, gamma)
    YY = _rbf_kernel(fake, fake, gamma)
    XY = _rbf_kernel(real, fake, gamma)
    return float(XX.mean() + YY.mean() - 2 * XY.mean())


def mmd_polynomial(real, fake, degree=2, gamma=1, coef0=0):
    real, fake = _flat(real), _flat(fake)
    XX = _polynomial_kernel(real, real, degree, gamma, coef0)
    YY = _polynomial_kernel(fake, fake, degree, gamma, coef0)
    XY = _polynomial_kernel(real, fake, degree, gamma, coef0)
    return float(XX.mean() + YY.mean() - 2 * XY.mean())


# ---------------------------------------------------------------------------
# PRD curves (Sajjadi et al., 2018)
# ---------------------------------------------------------------------------

def _prd_from_histograms(ref_dist, eval_dist, num_angles=1001, epsilon=1e-10):
    angles = np.linspace(epsilon, np.pi / 2 - epsilon, num_angles)
    slopes = np.tan(angles)[:, None]
    ref2d = ref_dist[None, :]
    eval2d = eval_dist[None, :]
    precision = np.minimum(ref2d * slopes, eval2d).sum(axis=1)
    recall = (precision / slopes[:, 0])
    return np.clip(precision, 0, 1), np.clip(recall, 0, 1)


def precision_recall_distribution(real, fake, num_clusters=20, num_angles=1001,
                                  num_runs=10, seed=0):
    """PRD curve via joint k-means histograms, averaged over cluster runs.

    Returns (precision, recall) arrays of length num_angles.
    """
    real, fake = _flat(real), _flat(fake)
    num_clusters = min(num_clusters, max(2, (len(real) + len(fake)) // 2))
    joint = np.concatenate([real, fake], axis=0)
    precisions, recalls = [], []
    for run in range(num_runs):
        km = KMeans(n_clusters=num_clusters, n_init=3,
                    random_state=seed + run).fit(joint)
        labels_real = km.predict(real)
        labels_fake = km.predict(fake)
        ref_dist = np.histogram(labels_real, bins=num_clusters,
                                range=(0, num_clusters), density=True)[0]
        eval_dist = np.histogram(labels_fake, bins=num_clusters,
                                 range=(0, num_clusters), density=True)[0]
        ref_dist = ref_dist / max(ref_dist.sum(), 1e-12)
        eval_dist = eval_dist / max(eval_dist.sum(), 1e-12)
        p, r = _prd_from_histograms(ref_dist, eval_dist, num_angles)
        precisions.append(p)
        recalls.append(r)
    return np.mean(precisions, axis=0), np.mean(recalls, axis=0)


def prd_f_beta_score(prd_dist, beta=8.0, epsilon=1e-10):
    """Max F_beta and F_1/beta over a PRD curve.

    Returns (F_beta, F_1/beta) — the recall-weighted and precision-weighted
    summaries; the reference unpacks them as (recall, precision)
    (``sample_ncsn.py:142``).
    """
    precision, recall = prd_dist
    precision = np.asarray(precision)
    recall = np.asarray(recall)

    def max_f(b):
        num = (1 + b**2) * precision * recall
        den = b**2 * precision + recall + epsilon
        return float(np.max(num / den))

    return max_f(beta), max_f(1.0 / beta)


def f1_score(precision, recall, epsilon=1e-10):
    return float(2 * precision * recall / (precision + recall + epsilon))


def _plot_prd(prd_dists, labels=None, out_path=None):
    """Plot PRD curves (recall on x, precision on y)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(4, 4), dpi=150)
    for i, (precision, recall) in enumerate(prd_dists):
        label = labels[i] if labels else None
        plt.plot(recall, precision, label=label, alpha=0.8)
    plt.xlim([0, 1])
    plt.ylim([0, 1])
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    if labels:
        plt.legend(loc="lower left")
    plt.tight_layout()
    if out_path is not None:
        plt.savefig(out_path, format="png")
        plt.close(fig)
    return fig


# Namespace mirror of the reference's external ``prd`` module
# (``sample_ncsn.py:134``: ``metrics.prd.plot``).
prd = types.SimpleNamespace(plot=_plot_prd,
                            compute_prd=_prd_from_histograms)


# ---------------------------------------------------------------------------
# Improved precision / recall + realism (Kynkäänniemi et al., 2019)
# ---------------------------------------------------------------------------

def _knn_radii(data, k):
    d = euclidean_distances(data, data)
    np.fill_diagonal(d, np.inf)
    return np.sort(d, axis=1)[:, k - 1]


def _manifold_fraction(points, manifold, radii):
    """Fraction of points falling inside any manifold sample's k-NN ball."""
    d = euclidean_distances(points, manifold)
    return float((d <= radii[None, :]).any(axis=1).mean())


def precision_recall(real, fake, k=3):
    """Improved precision (fake in real manifold) and recall (vice versa)."""
    real, fake = _flat(real), _flat(fake)
    radii_real = _knn_radii(real, k)
    radii_fake = _knn_radii(fake, k)
    precision = _manifold_fraction(fake, real, radii_real)
    recall = _manifold_fraction(real, fake, radii_fake)
    return precision, recall


def realism_scores(real, fake, k=3):
    """Per-fake-sample realism R = max_r radius_r / dist(fake, r).

    Following the paper, only real samples with k-NN radius below the median
    are used (prunes sparse outliers that would inflate the score).
    """
    real, fake = _flat(real), _flat(fake)
    radii = _knn_radii(real, k)
    keep = radii < np.median(radii)
    if keep.sum() == 0:
        keep = np.ones_like(keep, bool)
    radii = radii[keep]
    d = euclidean_distances(fake, real[keep])
    return np.max(radii[None, :] / np.maximum(d, 1e-12), axis=1)


# ---------------------------------------------------------------------------
# NDB (Richardson & Weiss, 2018)
# ---------------------------------------------------------------------------

def ndb_score(real, fake, k=50, significance=0.05, seed=0):
    """Fraction of k-means bins where fake proportions differ significantly.

    Bins real samples with k-means, assigns fake samples to the nearest
    centroid, and runs a two-proportion z-test per bin; returns NDB/k in
    [0, 1] (0 = distributions indistinguishable at this resolution).
    """
    real, fake = _flat(real), _flat(fake)
    n_real, n_fake = len(real), len(fake)
    k = min(k, max(2, n_real // 2))
    km = KMeans(n_clusters=k, n_init=3, random_state=seed).fit(real)
    real_counts = np.bincount(km.labels_, minlength=k)
    fake_counts = np.bincount(km.predict(fake), minlength=k)

    p_real = real_counts / n_real
    p_fake = fake_counts / n_fake
    pooled = (real_counts + fake_counts) / (n_real + n_fake)
    se = np.sqrt(pooled * (1 - pooled) * (1 / n_real + 1 / n_fake))
    z = np.zeros(k)
    mask = se > 0
    z[mask] = (p_real[mask] - p_fake[mask]) / se[mask]
    z_crit = scipy.special.ndtri(1 - significance / 2)
    return float((np.abs(z) > z_crit).sum() / k)
