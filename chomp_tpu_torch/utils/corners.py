"""The prior-hypervolume corner set of the float32 serving gate.

The port's own copy of the JAX package's ``utils/corners.py`` table:
low/high (omega_m, sigma_8), the CPL (w0, wa) corners and an open case
(Omega_k = 0.10); all keep E^2(z) > 0 on z in [0, 25].
``tools/torch_measure_f32.py``, ``chip_smoke.py`` (phase 24) and
``tests/test_torch_corners.py`` read it.
"""

from __future__ import annotations

# name -> (omega_m0, omega_l0, sigma_8, w0, wa)
PRIOR_CORNERS = {
    "low_om_low_s8": (0.18, 0.82, 0.60, -1.0, 0.0),
    "high_om_high_s8": (0.42, 0.58, 1.00, -1.0, 0.0),
    "cpl_phantom": (0.278, 0.722, 0.811, -1.5, 0.5),
    "cpl_quintessence": (0.278, 0.722, 0.811, -0.5, -0.5),
    "open": (0.25, 0.65, 0.811, -1.0, 0.0),
}

#: The two near-fiducial points that the float32 gate adds to the
#: corners (the JAX package's tests/test_f32_budget.py).
NEAR_FIDUCIAL = ((0.25, 0.75, 0.811, -1.0, 0.0),
                 (0.31, 0.69, 0.811, -1.0, 0.0))


def corner_arrays(extra=()):
    """Column lists (om, ol, s8, w0, wa) over the corner set, plus any
    ``extra`` rows of the same 5-tuple shape."""
    rows = list(PRIOR_CORNERS.values()) + list(extra)
    om, ol, s8, w0, wa = (list(c) for c in zip(*rows))
    return om, ol, s8, w0, wa


def corner_batch(base, extra=NEAR_FIDUCIAL):
    """The corners (and ``extra``) as a cosmology batch on ``base``'s
    device and dtype: omega_m0, omega_l0, sigma_8, w0 and wa vary, every
    other field is ``base``'s."""
    from chomp_tpu_torch.parallel.sweep import broadcast_cosmo

    om, ol, s8, w0, wa = corner_arrays(extra)
    return broadcast_cosmo(base, omega_m0=om, omega_l0=ol, sigma_8=s8,
                           w0=w0, wa=wa)
