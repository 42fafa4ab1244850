"""Covariance-calibration statistics: the share of keypoint errors inside
the 99% chi-square bound of the network's predicted 2x2 covariance (the
predicted covariances must be calibrated for the chi2 gates of camera
RANSAC and BA to mean anything).

Port of `suo_slam_tpu/eval/calibration.py` (numpy, f64), used by
`python -m suo_slam_tpu_torch.plot_cov`.
"""

import numpy as np

# chi2.ppf(0.99, df=2)
CHI2_99_2DOF = 9.210


def cov_chi2(uv_pred, cov_pred, uv_gt):
    """Per-keypoint Mahalanobis chi2 of the error under the predicted 2x2
    covariance, by the closed-form inverse. uv_pred / uv_gt [..., 2],
    cov_pred [..., 2, 2] -> [...]."""
    res = np.asarray(uv_gt, np.float64) - np.asarray(uv_pred, np.float64)
    cov = np.asarray(cov_pred, np.float64)
    a, b, d = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    det = np.maximum(a * d - b * b, 1e-12)
    return (d * res[..., 0] ** 2 - 2 * b * res[..., 0] * res[..., 1]
            + a * res[..., 1] ** 2) / det


def pct_inbounds(chi2s, bound=CHI2_99_2DOF):
    """% of chi2 values inside the bound (a calibrated predictor sits near
    99); nan for none."""
    chi2s = np.asarray(chi2s)
    if chi2s.size == 0:
        return float("nan")
    return 100.0 * float((chi2s <= bound).mean())
