"""The port's noise schedules and DDPM constants against ``smd_tpu``'s."""
import numpy as np
import pytest
import torch

from smd_tpu.diffusion import schedules as jax_schedules
from smd_tpu_torch.diffusion import schedules

CASES = [
    ("linear", 1e-6, 0.01, 1000),    # the flagship sampler's betas
    ("cosine", 1.0, 1e-2, 1000),
    ("geometric", 1e-4, 0.02, 1000),
    ("fibonacci", 1e-6, 0.01, 20),   # fibonacci betas pass 1 within ~30
]


@pytest.mark.parametrize("kind,begin,end,num", CASES)
def test_noise_schedule_matches(kind, begin, end, num):
    ours = schedules.noise_schedule(begin, end, num, kind)
    ref = np.asarray(jax_schedules.noise_schedule(begin, end, num, kind))
    assert ours.dtype == torch.float32 and ours.shape == (num,)
    # Both are numpy float64 rounded once to float32: equal.
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("kind,begin,end,num", CASES)
def test_ddpm_constants_match(kind, begin, end, num):
    betas = schedules.noise_schedule(begin, end, num, kind)
    ours = schedules.ddpm_constants(betas)
    ref = jax_schedules.ddpm_constants(
        jax_schedules.noise_schedule(begin, end, num, kind))
    assert ours.num_steps == ref.num_steps == num
    for field in ("betas", "alphas", "alphas_prod", "alphas_prod_prev",
                  "sqrt_alphas_prod", "sqrt_recip_alphas_prod",
                  "sqrt_alphas_prod_m1", "posterior_mu1", "posterior_mu2",
                  "posterior_log_var"):
        a = getattr(ours, field)
        assert a.dtype == torch.float32, field
        # float32 on both sides, same association of the cumulative product;
        # sqrt/exp/log may differ by an ulp between numpy and XLA.
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-6, atol=0, err_msg=field)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        schedules.noise_schedule(1.0, 0.1, 4, "nope")
