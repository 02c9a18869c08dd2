"""chomp_tpu_torch: the PyTorch + CUDA port of the JAX package.

The port so far is the w(theta) + gamma_t (+ xi_+-, + the kappa_CMB
cross) pipeline (``parallel.sweep.make_pipeline``) on both of its
routes: the lattice route (``method="fft"``, separable or exact-z, flat
or curved sky) and the GL + cubic-table route (``method="table"``, with
``correlation``'s public surface); and the separable tomographic 3x2pt
pipeline with its nuisances (``parallel.sweep.make_tomographic_pipeline``).
Their options are ported: the EH98 BAO transfer (``linear``), the
Tinker mass function (``mass``), halofit and linear mm legs
(``nlpower``), the CMB-lensing window (``cmblens``), the curved-sky
operators (``curved``) and the non-Limber repair with its RSD term
(``nonlimber``); every HOD family of the JAX package (``hod``) rides
every route.  Three
hand-written CUDA kernels carry them: the halo-model mass contraction
(``ops.halo_contract``), the compensated operator contraction
(``ops.df32``) and the Hankel-operator product (``ops.hankel_matmul``),
each with a backward kernel, so both routes differentiate on the card;
``inference`` holds the JAX package's inference surface (theory map,
Jacobian, Gaussian / Poisson / composite likelihoods, Fisher, MOPED,
templates and scale cuts, MAP fit, HMC and adaptive HMC, the
external-sampler bridge and ensemble sampler) and ``emulator`` its MLP
emulator.  The flat-sky, separable-growth covariance stack gives those
likelihoods their matrices, float64 on the card: ``trispectrum`` (the
halo-model T̄(k1, k2) with mixed tracers), ``mask`` (survey footprints
and the masked Gaussian covariance), ``ssc`` (the super-sample term) and
``covariance`` (Gaussian, connected and SSC blocks and the joint w +
gamma_t, 3x2pt and tomographic builders, with exact-z connected and
super-sample terms and the kappa_CMB probes), and ``curved`` (the same
builders on a masked sphere, with ``healpix`` to ingest survey maps), its
C_ell from kernel A on the k lattice.  The package imports torch, numpy
and scipy only; the JAX package beside it is its reference in the tests.
"""

from chomp_tpu_torch import (covariance, curved, healpix, mask, ssc,
                             trispectrum)
from chomp_tpu_torch.cmblens import CMBLensingSpec
from chomp_tpu_torch.covariance import (joint_3x2pt_covariance,
                                        joint_wtheta_gammat_covariance,
                                        tomographic_3x2pt_covariance)
from chomp_tpu_torch.curved import (PixelSphereMask, ProfileCurvedMask,
                                    SphericalCapMask, UniformSphereMask,
                                    curved_joint_3x2pt_covariance,
                                    curved_joint_wtheta_gammat_covariance,
                                    curved_tomographic_3x2pt_covariance)
from chomp_tpu_torch.hod import (HODKravtsov, HODMandelbaum, HODPoisson,
                                 HODZheng, default_hod)
from chomp_tpu_torch.mask import DiscMask, PixelMask, UniformMask
from chomp_tpu_torch.params import (DEFAULT_GRID, CosmoParams, GridSpec,
                                    HaloParams, default_cosmo, default_halo)
from chomp_tpu_torch.parallel.sweep import (Nuisance3x2pt, broadcast_cosmo,
                                            default_nuisance, make_pipeline,
                                            make_tomographic_pipeline)
from chomp_tpu_torch.projection import (DNdzGaussian, DNdzInterpolation,
                                        DNdzMagLim, DNdzShifted)

__all__ = ["CMBLensingSpec", "CosmoParams", "DEFAULT_GRID", "DNdzGaussian",
           "DNdzInterpolation", "DNdzMagLim", "DNdzShifted", "DiscMask",
           "GridSpec", "HODKravtsov", "HODMandelbaum", "HODPoisson",
           "HODZheng", "HaloParams", "Nuisance3x2pt", "PixelMask",
           "PixelSphereMask", "ProfileCurvedMask", "SphericalCapMask",
           "UniformMask", "UniformSphereMask", "broadcast_cosmo",
           "covariance", "curved", "curved_joint_3x2pt_covariance",
           "curved_joint_wtheta_gammat_covariance",
           "curved_tomographic_3x2pt_covariance", "default_cosmo",
           "default_halo", "default_hod", "default_nuisance", "healpix",
           "joint_3x2pt_covariance", "joint_wtheta_gammat_covariance",
           "make_pipeline", "make_tomographic_pipeline", "mask", "ssc",
           "tomographic_3x2pt_covariance", "trispectrum"]
