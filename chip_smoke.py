"""End-to-end smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints on its own lines; any failure exits non-zero):

1. device   -- require CUDA; print the card's name and power limit.
2. build    -- compile the hand-written CUDA kernels from numpyro_tpu_torch/csrc.
3. kernels  -- at the covtype shape (581,012 x 55 with the intercept, 256
               chains) run each GLM kernel and its plain PyTorch version on
               the same inputs; print errors, median times (CUDA events) and
               each kernel's bound from its count of operations and bytes.
               Each kernel is also held against the plain version at a ragged
               shape (100 chains, D = 70), must give the same bits twice, and
               the split kernel is timed at 64, 256 and 1,024 chains.
4. main     -- with every launch count set to 0: MCMC(NUTS) with 256
               vectorized chains on the covtype model in each precision mode.
               Split mode (the bench's) runs 100 + 5 transitions, f32 mode
               (``prepare_glm_data``'s default) 50 + 5, both at warmup depth
               5, and both must
               recover the generating coefficients to 0.05.  bf16 mode runs a
               short depth-6 chain whose draws must be finite (its quantized
               ``w`` stalls NUTS at this data concentration, so it has no
               coefficient gate).  Every potential evaluation of every run
               must have launched its mode's kernel exactly once.
               A fourth run drives NUTS in split mode through the per-step
               ``init``/``sample`` API (64 chains, 10 + 5, depth 5), which must launch
               the split kernel once per evaluation too; its warmup runs
               first, its ``post_warmup_state`` is saved with
               ``checkpoint.save_checkpoint`` and sampling resumes from it in
               memory (phase 22a resumes from the file).
5. f32/bf16 -- one batched potential-and-gradient evaluation of the f32- and
               bf16-mode models through ``batched_potential``, checked
               against the plain version.
6. ecs      -- HMCECS with the Taylor proxy on the same data (the bench's
               second leg): 1,024 chains, subsample 1,000 of 581,012 rows, 100
               blocks, 100 + 10 transitions at tree depth 5, on the default
               device, with the modes that ``auto`` resolves; the posterior means must recover
               the generating coefficients to 0.1.  Then the other modes by
               name (``bf16`` and ``lean`` panels, ``recompute`` proxy) at 256
               chains, 20 + 5, depth 3, gate 0.2.  This path is plain PyTorch
               (gathers, small products, nested JVPs) and launches none of
               the hand-written kernels.
7. dense    -- dense and structured mass matrices and forward-mode gradients,
               all on the GPU: (a) a correlated 5-d Gaussian under a dense
               mass, whose draws must give its stds to 15% and means to 0.3;
               (b) the horseshoe regression of
               ``examples/horseshoe_regression.py`` at its defaults (100 x 20,
               3 active) under a dense 42 x 42 mass pooled over 256 chains,
               whose posterior means of ``beta`` must be within ``HS_GATE``
               of the generating ones, with R-hat below ``HS_RHAT_GATE``; (c)
               the same with ``dense_mass=[("beta", "lambda")]``, whose
               exposed mass must be a dict of a 40 x 40 and a diagonal block;
               (d) the same with forward-mode gradients, which must agree with
               reverse mode on one batched evaluation; (e) the covtype model in
               split mode under a dense mass pooled over chains, with the 0.05
               gate, launching ``glm_split`` once per evaluation (counts set to
               0 just before, read just after).
8. svi      -- SVI on the default device, each leg with the counts set to 0
               just before its ``init`` and read just after its last step:
               (a) the MAP of the covtype model by ``AutoDelta`` with
               ``Trace_ELBO`` and ``Adam(0.01)``, 500 steps, split mode; (b)
               ``AutoDiagonalNormal`` with 16 particles, 1,000 steps; (c)
               ``AutoMultivariateNormal`` with 16 particles, 1,000 steps; each
               must recover the generating coefficients to 0.05 and launch
               ``glm_split`` once per step (all particles in one launch) beside
               its init traces.  (d) the HMCECS example's recipe: ``AutoDelta``
               on the subsampled model, 500 steps, error under 0.1 and no GLM
               launch; phase 6's ``lean`` run anchors its Taylor proxy at this
               MAP, so phase 8 runs before phase 6.  (e) the horseshoe of phase
               7 under ``AutoNormal`` with ``TraceMeanField_ELBO(8)``, 3,000
               steps, the median of ``beta`` within ``HS_SVI_GATE``.  One
               ``Trace_ELBO`` gradient at (b)'s params goes through
               ``glm_split`` and through the plain version on the same draws
               and must agree within ``glm.kernel_tolerances``; ``glm_split``
               is timed at 1 and 16 chains.

9. eight schools -- ``examples/eight_schools.py`` in its non-centred form
               (``handlers.reparam`` with ``LocScaleReparam(0)``) under
               ``NUTS(target_accept_prob=0.9)`` with 64 vectorized chains;
               ``theta`` comes back as a deterministic site through the
               postprocessing, shaped ``(C, n, 8)``, and ``mcmc.print_summary()``
               prints the table.  The posterior means and stds of ``mu``,
               ``tau`` and ``theta`` must lie within 4 Monte-Carlo standard
               errors of the JAX package's own run (``EIGHT_SCHOOLS_REF``);
               ``Predictive`` of ``obs`` must have shape ``(C n, 8)`` and
               residuals ``obs - theta`` of mean 0 and std ``sigma`` per
               school; ``log_likelihood`` must equal ``Normal(theta,
               sigma).log_prob(y)``; then ``AutoNormal`` with ``Trace_ELBO``
               and one ``Predictive`` through the guide.  No GLM launch.
10. sv       -- ``examples/stochastic_volatility.py``'s model (``Exponential``,
               ``GaussianRandomWalk``, ``StudentT``) at T = 100 on returns made
               in numpy from a seed, 64 chains under pooled adaptation at
               capped depths; the largest gap over t between the posterior
               mean of ``s`` and the generating log volatility and the R-hat
               of ``sigma`` must be within ``SV_GATE`` and ``SV_RHAT_GATE``,
               which follow the JAX package's own run (``dev/sv_reference.py``).
11. hmm      -- ``examples/hmm_enum.py`` at its full size (T = 50, K = 2, data
               from numpy seed 0), its discrete states summed out by parallel
               enumeration: (a) NUTS on the ``scan`` form (the cheaper one per
               evaluation) with 64 chains, the posterior means of trans[0, 0],
               trans[1, 1] and sigma within ``HMM_GATE`` of the generating
               values; (b) a short run of the ``markov`` form, finite draws;
               (c) the enumerated log joint of both forms at 8 of (a)'s draws
               against a numpy forward algorithm and scipy's densities, to
               1e-5 relative; (d) ``AutoNormal`` under ``TraceEnum_ELBO``, the
               guide's medians within ``HMM_SVI_GATE``; (e)
               ``Predictive(infer_discrete=True)`` of the ``markov`` form from
               (a)'s draws, whose most frequent state must be the generating
               one at a share of the steps of at least ``HMM_DECODE_GATE``.
               The gates follow the JAX package's own runs
               (``dev/hmm_reference.py``); no GLM launch.
12. samplers -- the other MCMC kernels, each leg printing its seconds,
               evaluations and ms per evaluation: (a) ``SMC`` on 8-schools
               non-centred, 4,096 particles, the means of ``mu`` and ``tau``
               within ``SMC_GATE`` of ``EIGHT_SCHOOLS_REF`` and the log
               evidence within ``SMC_EVIDENCE`` of the JAX package's; (b)
               ``SMC`` on a conjugate Gaussian, the log evidence within 0.2
               of the exact one; (c) ``DiscreteHMCGibbs(NUTS)`` and (d)
               ``MixedHMC(HMC)`` on the mixtures of the JAX package's tests,
               under those tests' gates; (e) ``BarkerMH``, ``SA``, ``AIES`` and
               ``ESS`` on 8-schools non-centred, 64 chains each, and (f)
               ``BarkerMH`` with two ``"sequential"`` chains, the means of
               ``mu`` and ``tau`` within ``KERNEL_GATES`` of
               ``EIGHT_SCHOOLS_REF`` (``dev/smc_reference.py`` and
               ``dev/kernels_reference.py``).  Plain PyTorch; no GLM launch.

13. chees/guides -- (a) ``CheesHMC`` on the covtype model in split mode, 256
               chains, at most 16 leapfrog steps a transition: every step is
               one batched evaluation and one ``glm_split`` launch for all
               chains (launches = evaluations + the init search's model
               traces), the posterior means within ``CHEES_GATE`` of the
               generating coefficients; (b) one ``TraceGraph_ELBO`` loss and
               gradient with 20,000 particles on the model of
               ``tests/infer/test_gradient.py``, within 0.05 of the closed-form
               gradient; (c) ``AutoLowRankMultivariateNormal`` on 8-schools
               non-centred, the medians of ``mu`` and ``tau`` within
               ``LOWRANK_GATE`` of ``EIGHT_SCHOOLS_REF``; (d)
               ``AutoLaplaceApproximation`` fitted by ``Minimize()`` (BFGS) on
               the same model from a fixed start, its MAP and standard
               deviations within ``LAPLACE_GATE`` of the JAX package's
               (``dev/chees_reference.py``, ``dev/guides_reference.py``).
14. flows   -- the flow guides, NeuTra, DAIS and the batched guides: (a)
               ``AutoIAFNormal`` (3 flows, hidden [55, 55], ELU) on the
               covtype model in split mode at full size, ``IAF_RUN``: one
               ``glm_split`` launch a step for all particles beside the init
               traces, the mean of ``IAF_DRAWS`` draws of ``sample_posterior``
               within ``IAF_GATE`` of the generating coefficients, one ELBO
               gradient through the kernel against the plain version; (b)
               NUTS with 256 chains on ``NeuTraReparam`` of (a)'s guide, one
               launch an evaluation, ``transform_sample``'s posterior means
               within 0.05, the potential and gradient at 256 chains through
               the kernel against the plain version; (c) ``examples/neutra.py``'s
               dual moon through ``AutoBNAFNormal`` and NUTS on the NeuTra
               model, its draws on the moons' ring; (d) ``examples/dais_demo.py``'s
               ``AutoDAIS`` beside ``AutoDiagonalNormal``, within
               ``DAIS_GATE`` of the JAX package's run; (e)
               ``AutoSurrogateLikelihoodDAIS`` and the two batched guides on
               the models of ``tests/infer/test_autoguide_extra.py``, within
               0.3 (``dev/flows_reference.py``).  (c)-(e) launch no kernel.
15. semi    -- SKIM, AutoSemiDAIS and the new families: (a)
               ``examples/sparse_regression.py``'s SKIM model at the example's
               widths (N = 100, P = 20, S = 3, seed 0) under NUTS with 64
               vectorized chains, ``SKIM_RUN``: an ``(N, N)`` kernel a chain
               each evaluation, factored in float32 (a matrix that is not
               positive definite gives NaN, a divergent transition; warmup's
               count is printed); the active dimensions by the example's
               3-std rule must be exactly {0, 1, 2} and the singleton means
               within ``SKIM_GATE`` of the generating ones
               (``dev/skim_reference.py``); (b) ``AutoSemiDAIS`` with a global
               ``AutoNormal`` on the model of
               ``tests/infer/test_autoguide_extra.py::test_auto_semi_dais``,
               ``SEMI_RUN``: the test's criterion and the mean of theta within
               ``SEMI_GATE`` of the JAX package's runs
               (``dev/semi_dais_reference.py``); (c) the new distributions'
               ``log_prob``, ``cdf`` and ``icdf`` on CUDA tensors against CPU
               tensors, Gamma and Beta draws from a CUDA generator against
               their moments, and ``betaincinv``/``gammaincinv`` timed.  No
               GLM launch.
16. discrete -- the discrete, conjugate and directional families: (a)
               ``examples/ucbadmit.py``'s binomial GLMM on its 12-row table
               under NUTS with 64 vectorized chains (``UCB_RUN``), then
               ``Predictive`` on the draws (``torch.binomial`` under
               ``soft_vmap``); the posterior mean of ``bm`` and the example's
               mean |predicted - observed admit rate| within ``UCB_GATE`` of
               the JAX package's run; (b) ``examples/ssbvm_mixture.py``'s von
               Mises mixture on its 200 angles with the label enumerated
               (``SSBVM_RUN``, 256 chains), the sorted ``loc_phi`` means within
               ``SSBVM_GATE`` (``dev/discrete_reference.py``), and its
               enumerated potential and gradient at 8 points against the
               CPU's; (c) the new
               classes' ``log_prob``, ``cdf`` and ``icdf`` on CUDA tensors
               against CPU tensors, draws from a CUDA generator through the
               port's ``gof`` (the binomial on both sides of its switch,
               Poisson, Multinomial, VonMises, SineBivariateVonMises, Gamma),
               a Gamma draw's reparameterised gradient at shapes 0.3 to 1e5
               against the CPU's, and
               the Bessel quadrature timed against the ``i0e``/``i1e``
               recurrence.  No GLM launch.
17. structured -- the structured and matrix families: (a) the LKJ covariance
               model of the Stan User's Guide (``LKJCholesky(5, 2)``, 500 rows
               of a 5-d ``MultivariateNormal``) under NUTS (``LKJ_RUN``), which
               maps ``L`` through ``biject_to(corr_cholesky)`` at every
               evaluation; the largest error of the 10 posterior mean
               correlations within ``LKJ_GATE`` of the JAX package's
               (``dev/structured_reference.py``); (b) an ordered Gaussian
               mixture (``OrderedTransform`` locations, ``MixtureSameFamily``
               likelihood, 300 points); each model's potential and gradient
               at 256 points on the card against the CPU's, with the host
               syncs of that evaluation counted, and the mixture's locations
               increasing at every point; (c) every new
               class's ``log_prob`` and every new transform's forward map,
               inverse and log-determinant on CUDA tensors against CPU
               tensors, draws of seven samplers on a CUDA generator through
               the port's ``gof``, a ``Wishart`` reparameterised gradient
               against the CPU's on the same draws, and ``CAR.log_prob`` at
               100 sites timed with its host syncs.  No GLM launch.
18. dsl     -- the model DSL's tail: (a) ``examples/annotation.py``'s
               Dawid-Skene model at its widths (3 classes, 5 annotators, 60
               items, the example's data), its class ``c`` enumerated through
               ``Vindex(beta)[positions, c, :]``: the potential and gradient
               at 256 points on the card against the CPU's, then NUTS
               (``ANNOT_RUN``), the largest error of the posterior mean class
               shares against the shares the data were drawn from within
               ``ANNOT_GATE`` of the JAX package's (``dev/annotation_reference.py``);
               (b) a model that uses ``obs_mask``, ``collapse`` with a latent
               second parameter, ``cond`` on a latent predicate, ``scale``,
               ``scope`` and ``plate_stack``: its potential and gradient at 256
               points on the card against the CPU's and against its twin
               written without those handlers, with the host syncs of an
               evaluation counted with validation off (no more than the
               twin's) and on.  No GLM launch.
19. tail    -- the inference tail: (a) ``initialize_model`` at 256 chains on
               the covtype model in split mode at full size under
               ``init_to_median``, ``init_to_mean``, ``init_to_feasible``,
               ``init_to_sample`` and ``init_to_value``: the potential and
               gradient at the found params against the plain version within
               ``glm.kernel_tolerances``, zeros from ``init_to_feasible`` and
               ``init_to_mean`` and the given values from ``init_to_value``,
               exactly, and the spread over chains of ``init_to_median`` (and
               ``init_to_sample``) within 4 Monte-Carlo errors of the exact
               one; every model trace and batched evaluation launches
               ``glm_split`` once.  Then NUTS from ``init_to_median``
               (``INIT_RUN``), ``transfer_states_to_host`` (the draws on the
               host equal the card's bit for bit) and
               ``parallel.cross_chain_diagnostics`` on the card against
               ``split_gelman_rubin`` and ``effective_sample_size`` on the
               CPU.  (b) ``get_dependencies``, ``get_model_relations`` and
               ``generate_graph_specification`` of the covtype model (each
               call launches ``glm_split`` for its trace and under its
               provenance pass, never the plain version) and of 18b's DSL
               model against the JAX package's (``INSPECT_REF``,
               ``dev/inspect_reference.py``), and ``compute_log_probs`` of
               the DSL model on the card against the CPU's.
20. contrib -- (a) ``examples/hsgp_example.py``'s model at its widths (80
               points, m = 20, ell = 1.5, the example's data) through the
               port's ``contrib.hsgp``: its potential and gradient at 256
               points on the card against the CPU's with the host syncs of
               an evaluation, then NUTS from ``init_to_median``
               (``HSGP_RUN``), the posterior means of ``length`` and
               ``noise`` within 4 combined Monte-Carlo errors of the JAX
               package's run (``HSGP_REF``, ``dev/contrib_reference.py``);
               (b) the Matérn (nu 1.5, 2.5) and periodic fragments' potentials
               on the card against the CPU's, and the periodic density at
               length 0.05 finite and within 1e-4 of scipy's ``ive``; (c)
               ``contrib.nested_sampling.NestedSampler`` on the conjugate
               model of ``tests/contrib/test_nested_sampling.py`` (log Z
               against the analytic one) and on
               ``examples/gaussian_shells.py``'s two shells under the
               example's two asserts; (d) ``contrib.stochastic_support``'s
               ``DCC`` and ``SDVI`` on the two-branch model of
               ``tests/contrib/test_stochastic_support.py``, each branch's
               weight within 0.1 of the exact one, with the host syncs of an
               evaluation of a branch's model.  No GLM launch.
21. stein   -- contrib part two: (a) ``SVGD`` on the covtype model in split
               mode at full width, the SVGD paper's experiment
               (``STEIN_COVTYPE``: 100 particles, ``Adagrad``,
               ``RBFKernel()``): one ``glm_split`` launch a step for all
               particles (B = 100) beside the init traces, the particles'
               mean within 0.05 of the generating coefficients, their
               per-coefficient std beside NUTS's, the host syncs of a step,
               and ``glm_split`` at 100 chains timed beside its bound; (b)
               ``examples/stein_bnn.py`` at its widths (``STEIN_BNN``: 8
               particles, 2 ELBO draws, ``AutoNormal``, ``Adagrad(0.5)``),
               then ``MixtureGuidePredictive``'s draws of ``y``, whose mean's
               RMSE against ``0.5 sin(4x)`` is within ``STEIN_BNN_GATE`` of
               the JAX package's run (``dev/stein_reference.py``); (c)
               ``ASVGD`` on the Gaussian of ``tests/contrib/test_einstein.py``,
               the SVGD force under each Stein kernel and one ``SteinVI`` step
               under ``ProbabilityProductKernel`` on the card against the
               same calls on CPU tensors from the same particles and draws.
22. port tail -- the port's last modules: (a) phase 4's per-step leg resumed
               from its checkpoint on disk (``checkpoint.restore_checkpoint``
               onto the card, the generator's state included): its first
               ``RESUME_TRANSITIONS`` transitions through ``glm_split`` must
               equal the leg's own, resumed in memory, bit for bit, with one
               launch an evaluation; (b) ``examples/vae.py`` at its widths
               (784 -> 64 -> 16, batch 64 of the MNIST surrogate of
               ``examples.datasets``) through ``contrib.module.torch_module``,
               ``VAE_STEPS`` of ``Adam(1e-3)``: the loss must fall and stay
               finite (the example's check), the ELBO at the same weights and
               draws on the card within ``VAE_RTOL`` of the CPU's, with the
               host syncs of a step; (c) ``examples/minipyro.py`` through
               ``compat`` (``MINIPYRO_STEPS``), the example's gate on
               ``loc_q`` and its trajectory on the card within
               ``MINIPYRO_RTOL`` of the CPU's.  22b and 22c launch no GLM
               kernel.

23. ranks   -- chains and data across processes: two ranks spawned from
               this script (``--phase23-rank``) when it starts share the one
               card over gloo; they join and lay out their data while the
               kernels build, warm up on the card before phase 3 (the script
               waits for them, and counts the wait in phase 23), idle through
               phases 3-22 and start when phase 22 ends.
               (a) phase 4's per-step leg with its 64 chains sharded 2 x 32
               (``MCMC(chain_method="parallel")`` on a ``chain_mesh``): the
               draws and potential energies gathered on each rank must equal
               the leg's own bit for bit, one ``glm_split`` launch an
               evaluation on each rank; (b) a 1 x 2 data mesh: each rank's
               ``glm_split`` on its 290,506 rows plus one ``all_reduce`` of
               loglik and gradient, at phase 3's 256 chains, within
               ``glm.kernel_tolerances`` of ``glm_split`` on all 581,012 rows;
               the kernel on a shard timed at 32 and 256 chains, the sum
               timed; then pooled NUTS on the data-sharded model, whose ranks
               must draw the same panel; then ``glm_fused`` in f32 and bf16
               mode on the shard through the model's op, one launch and one
               ``all_reduce`` each, within ``glm.kernel_tolerances`` of the
               kernel on all rows, and timed at 32 and 256 chains.  (c)
               HMCECS with the Taylor proxy at phase 8d's MAP on the 1 x 2
               data mesh (``DATA_ECS``: the bench's subsample and blocks),
               held against the same leg run by this script on all rows: the
               first evaluation's potential and gradient within
               ``DATA_ECS_RTOL``, the posterior means within the ECS modes'
               gate, one ``all_reduce`` over the data a Gibbs step and none
               an evaluation, the same draws on both ranks.  (d) ChEES at
               ``CHEES_RUN``'s step size and trajectory with its 64 chains
               sharded 2 x 32 (``SHARDED_CHEES``): draws and adaptation equal
               the same leg's in this script bit for bit, one ``glm_split``
               launch an evaluation.  (e) the covtype model written as a JAX
               user writes it over ``shard_data``'s rows (``model_rows``:
               ``Bernoulli(logits=X @ w)`` with ``obs=y`` under a plate of
               all 581,012 rows, no GLM op) on the 1 x 2 data mesh: its
               potential and gradient at phase 3's first 32 chains within
               ``glm.kernel_tolerances`` of 23b's data-sharded ``glm_fused``
               f32 on the same shard, two ``all_reduce``s over the data an
               evaluation (the site's sum and the gradient's), then pooled
               NUTS from phase 8d's MAP (``ROWS_NUTS``), the same draws on
               both ranks, the posterior means within its gate of the
               generating coefficients, no GLM launch.  (f) one Gibbs step
               of 23c's HMCECS in ``panel_mode="lean"`` from 23c's seed: its
               indices, potentials and draws equal 23c's first step (carry
               mode) bit for bit, one ``all_reduce`` over the data an
               evaluation (every panel of the evaluation at once) and one
               for the proxy's statistics at the new indices.  (g) covtype
               with a latent ``e`` for each of its 581,012 rows
               (``model_row_latent``: overdispersed logistic regression,
               ``y ~ Bernoulli(logits=X @ w + tau * e)``), ``e`` whole on
               every rank and cut to its rows: one evaluation at
               ``ROW_LATENT_RUN``'s 8 chains with a logsumexp and the
               columns' maxima over the rows, timed, against a plain
               version summed by explicit all_reduces (potential rtol 1e-5,
               gradients rtol 1e-4 and atol 1e-4 of the largest component),
               ``e``'s gradient whole and alike on both ranks, 7
               all_reduces over the data; pooled NUTS from phase 8d's MAP
               (tau small, e at 0), the same draws on both ranks, 23e's
               gate; ``Predictive`` of ``ROW_LATENT_DRAWS`` draws of ``y``
               over the rows against this script's on all rows from the
               same generator (the draws that differ counted, and bounded
               by the probabilities' differences).  A rank that fails, or
               runs past ``RANK_TIMEOUT``, fails the script.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

import atexit
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.diagnostics import effective_sample_size, split_gelman_rubin
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from numpyro_tpu_torch.compat import distributions as compat_dist
from numpyro_tpu_torch.compat import infer as compat_infer
from numpyro_tpu_torch.compat import ops as compat_ops
from numpyro_tpu_torch.compat import optim as compat_optim
from numpyro_tpu_torch.compat import pyro as compat_pyro
from numpyro_tpu_torch.contrib.module import torch_module
from numpyro_tpu_torch.examples.datasets import MNIST, load_dataset
from numpyro_tpu_torch.distributions.util import betaincinv, gammaincinv
from numpyro_tpu_torch.contrib.control_flow import cond, scan
from numpyro_tpu_torch.contrib.einstein import (
    ASVGD, SVGD, GraphicalKernel, IMQKernel, LinearKernel, MixtureGuidePredictive, MixtureKernel,
    ProbabilityProductKernel, RadialGaussNewtonKernel, RandomFeatureKernel, RBFKernel, SteinVI,
)
from numpyro_tpu_torch.contrib.einstein.steinvi import SteinVIState
from numpyro_tpu_torch.contrib.hsgp import (
    hsgp_matern, hsgp_periodic_non_centered, hsgp_squared_exponential,
)
from numpyro_tpu_torch.contrib.hsgp.spectral_densities import diag_spectral_density_periodic
from numpyro_tpu_torch.contrib.nested_sampling import NestedSampler
from numpyro_tpu_torch.contrib.stochastic_support import DCC, SDVI
from numpyro_tpu_torch.contrib.enum import config_enumerate, enum, markov
from numpyro_tpu_torch.contrib.enum import log_density as enum_log_density
from numpyro_tpu_torch.infer import (
    AIES, ESS, HMC, HMCECS, MCMC, NUTS, SA, SMC, SVI, BarkerMH, CheesHMC, DiscreteHMCGibbs,
    MixedHMC, Predictive, Trace_ELBO, TraceEnum_ELBO, TraceGraph_ELBO, TraceMeanField_ELBO,
    get_dependencies, get_model_relations, init_to_feasible, init_to_mean, init_to_median,
    init_to_sample, init_to_value, log_likelihood,
)
from numpyro_tpu_torch.infer import autoguide
from numpyro_tpu_torch.infer.reparam import LocScaleReparam, NeuTraReparam
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_core import FlatLayout, batched_potential
from numpyro_tpu_torch.infer.inspect import generate_graph_specification
from numpyro_tpu_torch.infer.mcmc import POSTPROCESS_CHUNK
from numpyro_tpu_torch.ops import _cuda, glm
from numpyro_tpu_torch.ops.indexing import Vindex
from numpyro_tpu_torch.optim import Adagrad, Adam, Minimize
from numpyro_tpu_torch.parallel import cross_chain_diagnostics, pooled_step_size
from numpyro_tpu_torch.util import tree_leaves

N, D, CHAINS = 581_012, 55, 256
# tolerances of kernel against plain version (their reasons stand with
# ``glm.kernel_tolerances``, which the GPU tests share)
LL_RTOL, G_RTOL = glm.LL_RTOL, glm.G_RTOL

KERNELS = {
    # launch-count name: (mode, TPU kernel it replaces)
    "glm_split": ("split", "numpyro_tpu/ops/glm.py:264"),
    "glm_fused_f32": (torch.float32, "numpyro_tpu/ops/glm.py:370"),
    "glm_fused_bf16": (torch.bfloat16, "numpyro_tpu/ops/glm.py:370"),
}
# published peaks of one H100 SXM: dense bf16 on the tensor cores, f32 outside
# them, device memory
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
RAGGED = (70_000, 70, 100)  # n, d, chains: two d-blocks, a partial chain tile
SWEEP_CHAINS = (64, 256, 1024)
# main-path runs: kernel -> (warmup, samples, max_tree_depth, coefficient gate).
# The whole script must end within 1,200 s on the slowest host it meets, whose
# host-bound legs run up to 2.5 times as long as on the fastest: draws are cut
# (split 50 -> 30 -> 10, f32 25 -> 10 -> 5, bf16 20 -> 10 -> 5), never warmup,
# and the warmup depth of the split and f32 runs from 6 to 5 to make room for
# phase 11 (nearly every warmup transition filled the cap of 6).  The f32 run's
# draws went from 10 to 5 to make room for phase 21: its 10 draws took 17.37 s
# at depth 10 (2,232 evaluations), and 256 chains of 5 draws still hold its
# gate.  To make room for phase 22 the bf16 run's draws went from 10 to 5 (its
# 10 took 5.04 s, 632 evaluations; its draws need only be finite) and the
# per-step run's from 10 to 5 (its 10 took 3.72 s; phase 22a resumes its first
# 3): phase 8c, tried first, was 0.0931 off at 700 steps against the gate of
# 0.05 (NVIDIA H100 80GB HBM3, 700.00 W).  To make room for phase 23g the
# split run's draws went from 10 to 5: its 10 took 11.40 s at depth 10 (1,920
# evaluations) and 0.0082 of the 0.05 gate, and nothing else reads them but
# logs (phases 8, 13 and 21 print per-draw figures and std ratios from them).
RUNS = {
    "glm_split": (100, 5, (5, 10), 0.05),
    "glm_fused_f32": (50, 5, (5, 10), 0.05),
    "glm_fused_bf16": (20, 5, 6, None),
}
# chains, warmup, samples and tree depth of the per-step NUTS run; its depth
# went from 6 to 5 to make room for phase 23, which runs it again over two
# ranks (at 6: 622 evaluations, 6.97 s in the script and 18.16 s a rank in
# phase 23 on a host whose ECS leg took 37.05 ms an evaluation, NVIDIA H100
# 80GB HBM3, 700.00 W); its gates (finite draws, one launch an evaluation,
# 22a's and 23a's draws equal to its own) hold at any depth
PER_STEP = (64, 10, 5, 5)
# the HMCECS leg: chains, warmup, samples, max_tree_depth, coefficient gate.
# ``MCMC``'s per-step loop waits for the deepest tree of all chains at every
# transition, and a potential evaluation costs ~25 ms of host time: with the
# bench's sampling cap of 10 a few chains with a small adapted step size grow
# trees of 500-1,023 leapfrogs and one transition takes 23 s (NVIDIA H100 80GB
# HBM3, 700.00 W), so the main leg caps the depth in sampling as in warmup.
# Every transition fills the capped tree (61.7 of 64 evaluations at depth 6),
# so the cap sets the leg's time: 5 since the script outgrew its time limit,
# and the draws are cut from 100 to 50 to 10 (10,240 draws).
SUBSAMPLE, NUM_BLOCKS = 1000, 100
ECS_MAIN = (1024, 100, 10, 5, 0.1)
# the other modes by name, their draws cut from 20 to 5 to make room for phase
# 7, their depth from 6 to 5 as the main leg's, then to 4 and to 3 to make
# room for phase 23.  Their max |mean(w) - true_w| (bf16, lean, recompute)
# against the gate of 0.2: at depth 5 0.0171, 0.0114 and 0.0101 (about 20 s
# each, 28.1-29.5 of 32 evaluations a transition), at depth 4 0.0160, 0.0106
# and 0.0088 (8.7-10.1 s each, 15.1 of 16), NVIDIA H100 80GB HBM3, 700.00 W
ECS_MODES = (256, 20, 5, 3, 0.2)
# phase 7.  Every tick costs 4-12 ms of host time, and warmup waits at every
# transition for the deepest tree of all chains, so the legs cap the warmup
# depth low, keep their warmup length and take few draws.
# (a) the target of tests/infer/test_mcmc.py:36-58: chains, warmup, samples,
# max_tree_depth
GAUSS_DIM, GAUSS_RUN = 5, (256, 300, 50, (4, 10))
# (b-d) the horseshoe at the example's defaults: rows, coefficients, active
HS_DATA = (100, 20, 3)
# max(2e, e + 0.05), where e = 0.085 is the line that the JAX package's own
# run of the example at its defaults prints (`python
# examples/horseshoe_regression.py` on the CPU: 1 chain, 500 + 500)
HS_GATE = 0.17
# chains, warmup, samples, max_tree_depth, extra NUTS options.  A draw costs
# ~210 leapfrogs after warmup (the funnel of tau and lambda), so (b) keeps 10
# draws and (c) caps its sampling depth at 6 (it has no R-hat gate).  The
# 42 x 42 estimate of (b) is pooled over the chains: with per-chain estimates
# the JAX package's run at 256 chains, 200 + 200 leaves R-hat of beta at 1.096
# (1.039 pooled; `JAX_PLATFORMS=cpu python3 -m dev.horseshoe_reference`).
HS_RUNS = {
    "dense": (256, 200, 10, (5, 10), {"dense_mass": True, "pooled_adaptation": True}),
    "structured": (64, 100, 5, (4, 6), {"dense_mass": [("beta", "lambda")]}),
    "forward": (64, 10, 5, 5, {"dense_mass": True, "forward_mode_differentiation": True}),
}
# R-hat of beta after 10 draws: 1 + max(2 (r - 1), r - 1 + 0.05), the rule of
# HS_GATE, where r = 1.2115 is what the JAX package's own run of leg (b) gives
# (`JAX_PLATFORMS=cpu python3 -m dev.horseshoe_reference 256 200 10 5 pooled`;
# 1.111 at 30 draws, and with warmup depth 6, 1.054 at 60 and 1.039 at 200,
# more than the run's time allows)
HS_RHAT_GATE = 1.423
# (e) covtype, split mode, dense mass pooled over chains
DENSE_COVTYPE = (100, 20, (6, 10), 0.05)
# phase 8, SVI with Adam(0.01).  Covtype legs: guide, particles, steps, and the
# model traces of init that launch the kernel: the guide's prototype trace, its
# init search (for init_to_median a trace under the strategy and the potential;
# init_to_uniform draws without a trace) and SVI.init's trace of the model
# 8b's steps went from 1,500 to 1,000 to make room for phase 21: at 1,500 its
# location was 0.0087 off (NVIDIA H100 80GB HBM3, 700.00 W), and 8c's 1,000
# steps of the wider guide reach 0.0164 against the gate of 0.05.
SVI_LEGS = {
    "8a": ("AutoDelta", 1, 500, 4),
    "8b": ("AutoDiagonalNormal", 16, 1000, 3),
    "8c": ("AutoMultivariateNormal", 16, 1000, 3),
}
SVI_GATE = 0.05
# (d) AutoDelta on the subsampled model: steps, gate (the ECS gate)
SVI_ECS = (500, 0.1)
# (e) the horseshoe under AutoNormal and TraceMeanField_ELBO: particles, steps.
# The gate is max(2e, e + 0.05), the rule of HS_GATE, for e = 0.0797, what the
# JAX package's own fit of the same guide, ELBO, optimizer and length gives
# (`JAX_PLATFORMS=cpu python3 -m dev.svi_horseshoe_reference`; 0.0786-0.0850
# over five seeds)
HS_SVI = (8, 3000)
HS_SVI_GATE = 0.159
# phase 9, 8-schools (examples/eight_schools.py:13-15), non-centred: chains,
# warmup, samples, tree depths in warmup and sampling.  Its budget is 20 s on
# a host where phase 6's main leg takes 24.0 ms per evaluation, on which the
# phases before it take 492 s, and phases 9 and 10 together may add at most
# 43 s there.  An evaluation costs 8-12 ms of host time on the card (NVIDIA
# H100 80GB HBM3, 700.00 W), so the run takes about 1,000: warmup waits at
# every transition for the deepest of the 64 trees, so its depth is capped
# at 3 (7 evaluations a transition); sampling runs the chains' trees side by
# side, about 60 evaluations a draw, so it takes 10 draws.
ES_Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
ES_SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)
ES_RUN = (64, 50, 10, (3, 10))
# the guide leg: Adam step size, steps, predictive draws
ES_SVI = (0.05, 300, 1000)
# the JAX package's own run at ES_RUN: posterior mean, std and their
# Monte-Carlo standard errors (``mc_moments``) per site
# (`JAX_PLATFORMS=cpu python3 -m dev.eight_schools_reference`, key 0, on the
# CPU; its runs with keys 1 and 2 are within 0.687 and 0.404 of this gate of
# these numbers)
EIGHT_SCHOOLS_REF = {
    "mu": {
        "mean": 4.68292,
        "std": 3.2366,
        "se_mean": 0.11057,
        "se_std": 0.15238,
    },
    "tau": {
        "mean": 3.35685,
        "std": 3.05305,
        "se_mean": 0.111,
        "se_std": 0.16472,
    },
    "theta": {
        "mean": [6.19109, 5.0938, 4.22517, 4.9123, 3.99447, 4.29002, 6.27283, 4.94206],
        "std": [5.53485, 4.58823, 5.1635, 4.38886, 4.4885, 4.41399, 4.78151, 4.89771],
        "se_mean": [0.18523, 0.14713, 0.1801, 0.15895, 0.13966, 0.15283, 0.15349, 0.17037],
        "se_std": [0.26195, 0.16153, 0.29944, 0.19308, 0.14249, 0.18409, 0.18468, 0.20465],
    },
}
# phase 10, stochastic volatility at T = 100: chains, warmup, samples, tree
# depths in warmup and sampling.  Its budget is 30 s on the same host, within
# the 43 s of both phases, and an evaluation costs 9-14 ms: every tree fills
# its capped depth, so 100 x 7 + 10 x 31 evaluations.
SV_T = 100
SV_RUN = (64, 100, 10, (3, 5))
# max(2e, e + 0.05), the rule of HS_GATE, where e is the largest gap over t
# between the posterior mean of s and the generating log volatility in the
# JAX package's own run at SV_RUN; R-hat of sigma by the rule of HS_RHAT_GATE
# (`JAX_PLATFORMS=cpu python3 -m dev.sv_reference`, key 0, on the CPU: e =
# 1.7191, r = 1.8791; keys 1 and 2 give e = 1.7260 and 1.7279, r = 2.0001
# and 1.8340.  sigma does not mix in any run this budget allows: at 20 draws
# and depths (5, 6) JAX's r is 1.40-1.51, so the R-hat gate holds the port
# to the reference's behaviour at this length, not to convergence)
SV_GATE = 3.4381
SV_RHAT_GATE = 2.7581
# phase 11, the HMM of examples/hmm_enum.py (BASELINE config 5) at its full
# size: T = 50 steps, K = 2 states, data from numpy seed 0; the generating
# trans[0, 0], trans[1, 1] and sigma.  Its budget is 25 s on a host where
# phase 6's main leg takes 24.0 ms per evaluation.
HMM_T = 50
HMM_TRUE = (0.85, 0.75, 0.3)
HMM_LOCS = (-1.0, 1.0)
# (a) NUTS on the scan form, the cheaper one per evaluation (16.1 against
# 91.1 ms inside the whole script on the card, NVIDIA H100 80GB HBM3,
# 700.00 W): chains, warmup, samples, tree depths in warmup and sampling;
# (b) the markov form, short.  Cut to fit 25 s: (a)'s draws 20 -> 10 and
# warmup depth 3 -> 2, (b)'s depths (3, 3) -> (2, 2) -> (1, 1)
HMM_RUN = (64, 100, 10, (2, 5))
HMM_OTHER = (64, 10, 10, (1, 1))
# (d) SVI: Adam step size and steps of AutoNormal under TraceEnum_ELBO
HMM_SVI = (0.05, 300)
# max(2e, e + 0.05), the rule of HS_GATE, where e is the largest gap over
# trans[0, 0], trans[1, 1] and sigma between the posterior mean (for (d) the
# guide's median) and the generating value in the JAX package's own run at
# the same configuration, and the decoding share a of (e) less 0.05
# (`JAX_PLATFORMS=cpu python3 -m dev.hmm_reference`, key 0, on the CPU: e =
# 0.0581, 0.0813 for (d), a = 1.0; keys 1 and 2 give e = 0.0637 and 0.0587,
# 0.0765 and 0.1049 for (d), a = 1.0)
HMM_GATE = 0.1162
HMM_SVI_GATE = 0.1625
HMM_DECODE_GATE = 0.95
# phase 12, the other MCMC kernels.  Its budget is 20 s on a host where phase
# 6's main leg takes 24.0 ms per evaluation.  (a) SMC on 8-schools
# non-centred: particles, the defaults otherwise; (b) SMC on the conjugate
# Gaussian of tests/infer/test_smc.py: particles, MH steps a stage
SMC_RUN = 4096
SMC_GAUSS = (2000, 10)
# (c) DiscreteHMCGibbs(NUTS) on the mixture of tests/infer/test_hmc_gibbs.py
# and (d) MixedHMC(HMC(trajectory_length=1.2), num_discrete_updates=4) on the
# mixture of tests/infer/test_mixed_hmc.py: chains, warmup, samples (and NUTS's
# tree depths in warmup and sampling); their gates are those tests' own
GIBBS_RUN = (256, 60, 40, (2, 3))
MIXED_RUN = (256, 60, 24)
# (e) BarkerMH, SA, AIES and ESS on 8-schools non-centred, 64 chains each:
# warmup and samples, cut so that each leg takes at most 2 s; (f) BarkerMH
# with two chains run one after the other (chain_method="sequential")
KERNEL_RUNS = {"BarkerMH": (64, 100, 50), "SA": (64, 100, 100), "AIES": (64, 30, 20),
               "ESS": (64, 8, 6)}
SEQ_RUN = (2, 50, 25)
# max(2e, e + 0.05), the rule of HS_GATE, per site, where e is the largest gap
# over keys 0-2 between the JAX package's posterior mean at the leg's
# configuration and EIGHT_SCHOOLS_REF's; the log evidence within max(2d, d +
# 0.05) of JAX's key-0 value, d the spread of JAX's values over keys 0-2
# (`JAX_PLATFORMS=cpu python3 -m dev.smc_reference` and `python3 -m
# dev.kernels_reference`, on the CPU)
# (dev.smc_reference: means of mu 4.3321, 4.5978, 4.2095 and of tau 3.5225,
# 3.6769, 3.6544 for keys 0-2; log evidence -31.3360, -31.2186, -31.2944.
# dev.kernels_reference: at these lengths the kernels are far from converged
# on 8-schools, SA furthest, and the gates follow the reference's spread)
SMC_GATE = {"mu": 0.9468, "tau": 0.6402}
SMC_EVIDENCE = (-31.3360, 0.2347)
KERNEL_GATES = {
    "BarkerMH": {"mu": 1.8411, "tau": 1.1633},
    "SA": {"mu": 8.9837, "tau": 2.3502},
    "AIES": {"mu": 4.1842, "tau": 1.7345},
    "ESS": {"mu": 6.6601, "tau": 3.0264},
    "sequential": {"mu": 3.8619, "tau": 5.1245},
}

# phase 13.  Its budget is 20 s on a host where phase 6's main leg takes 24.0
# ms per evaluation.  (a) ChEES on covtype in split mode: chains, warmup,
# samples, max_num_steps, and the first step size and trajectory length,
# chosen in a CPU rehearsal at a tenth of the rows (the step size there
# scaled by sqrt(1/10)); every transition takes num_steps + 1 evaluations
# (at most 17), so 120 transitions take at most 2,040
CHEES_RUN = (256, 100, 20, 16, 0.005, 0.05)
# the model traces of ChEES's init (the prototype trace; init_to_uniform
# draws without one), each one glm_split launch at one chain, beside the
# counted batched evaluations
CHEES_INIT_TRACES = 1
# the bench's 0.05 (bench.py:268-272): the JAX package's own CheesHMC at
# CHEES_RUN meets it (`JAX_PLATFORMS=cpu python3 -m dev.chees_reference`)
CHEES_GATE = 0.05
# (b) TraceGraph_ELBO on the model of tests/infer/test_gradient.py:70-108:
# particles, the guide's logit; the gate is that test's own
TG_RUN = (20000, 0.2)
TG_GATE = 0.05
# (c) AutoLowRankMultivariateNormal on 8-schools non-centred at ES_SVI's
# step size and steps.  max(2e, e + 0.05), the rule of HS_GATE, per site,
# where e is the largest gap over keys 0-2 between the JAX package's guide
# median after the same fit and EIGHT_SCHOOLS_REF's mean (its packed guides
# drop log q, ROADMAP Queue 3, so its fit sits near the MAP, far from the
# posterior mean: `JAX_PLATFORMS=cpu python3 -m dev.guides_reference`)
LOWRANK_GATE = {"mu": 6.2028, "tau": 50.1045}
# (d) AutoLaplaceApproximation with Minimize() from LAPLACE_START: the JAX
# package's MAP (the packed unconstrained latent: mu, log tau, then
# theta_decentered) and Laplace standard deviations there, and the gate,
# max(2e, e + 0.05) for e the largest gap between the JAX package's float32
# and float64 fits (dev.guides_reference)
LAPLACE_START = {"mu": 0.0, "tau": 1.0, "theta_decentered": 0.0}
LAPLACE_MAP = (1.4329, 3.3664, 0.7231, 0.2025, -0.1172, 0.1679, -0.0766, -0.0131, 0.5109, 0.2631)
LAPLACE_STD = (4.9267, 0.9397, 0.5862, 0.3672, 0.5098, 0.3857, 0.35, 0.3862, 0.4786, 0.5435)
LAPLACE_GATE = 0.05

# phase 14, the flow guides, NeuTra, DAIS and the batched guides.  Its budget
# is 30 s on a host where phase 6's main leg takes 24.0 ms per evaluation.
# (a) AutoIAFNormal on covtype in split mode: 3 flows of hidden widths [D, D]
# and ELU, Trace_ELBO's particles and steps (Adam(0.01), as phase 8); the draws of
# sample_posterior whose mean is gated; the model traces of SVI.init that
# launch the kernel (the guide's prototype trace and the potential of its
# init search, then SVI.init's trace of the model)
IAF_RUN = (4, 300)
IAF_DRAWS = 1000
IAF_INIT_TRACES = 3
# max(2e, e + 0.05), the rule of HS_GATE, for e = 0.0256, the largest over
# keys 0-2 of the JAX package's own run at IAF_RUN (0.0256, 0.0254, 0.0245:
# 300 steps leave its fit short of the MAP; `JAX_PLATFORMS=cpu python3 -m
# dev.flows_reference iaf`, 50 s a key on the CPU)
IAF_GATE = 0.0756
# (b) NUTS on NeuTraReparam(14a's guide): chains, warmup, samples, tree
# depths in warmup and sampling, the covtype gate (bench.py:268-272)
NEUTRA_RUN = (256, 50, 10, (3, 4), 0.05)
# (c) examples/neutra.py's dual moon: SVI steps of AutoBNAFNormal(hidden
# factors [8, 8]) at the example's Adam(3e-3), then NUTS on the NeuTra model:
# chains, warmup, samples, depths; the least share of draws on the moons'
# ring (| |x| - 2 | under three of its widths, 0.4).  The share of draws
# with x0 > 0 is printed, not gated: reverse KL puts the BNAF fit on one
# moon for about half of the seeds (5 of 10 at 500 steps in a CPU run), and
# the JAX package's own run of the example visits one moon (share 1.00 at
# its defaults), so only the ring is gated
DUAL_MOON = (200, 3e-3, 64, 20, 10, (3, 4), 0.9)
# (d) examples/dais_demo.py's correlated logistic regression (100 rows): SVI
# steps at the example's Adam(5e-3) of AutoDiagonalNormal and
# AutoDAIS(K=4, eta_init=0.01), both started at w = 0 (init_to_value, so that
# runs differ only in their noise), Trace_ELBO's particles, draws of
# sample_posterior.  At 100 steps the annealing's step size grows in most
# runs and stays clipped at 0 in some (then the fit is a mean-field one):
# with 8 particles in 3 of 100 of the JAX package's runs and 13 of 100 of
# the port's, with 16 in 0 of 40 and 1 of 40 (CPU; `dev.flows_reference
# dais_spread`, `dev.dais_spread`; both packages' steps agree on the same
# draws, tests/test_torch_dais.py).  The reference: the JAX package's own
# AutoDAIS run at this configuration, key 0 (the posterior mean and sd of
# each coordinate of w's draws, and their correlation); the gates
# max(2e, e + 0.05), the rule of HS_GATE, for e the largest gap of keys 1-4
# to key 0: 0.0196 in the mean and sd, 0.1365 in the correlation.  The
# example's point is that the annealing recovers the correlation mean-field
# misses: the JAX package's mean-field runs miss both gates (mean and sd
# 0.133-0.140 off, correlation 0.387-0.433 off), and so must the port's
# (`JAX_PLATFORMS=cpu python3 -m dev.flows_reference dais 0 1 2 3 4`)
DAIS_DEMO = (100, 100, 5e-3, 16, 1000)
DAIS_GATE = {"mean": (0.222, 0.2351), "sd": (0.2004, 0.2098), "corr": -0.4115,
             "gate": 0.0696, "corr_gate": 0.2729}
# (e) tests/infer/test_autoguide_extra.py's models: steps, Adam step size
# and Trace_ELBO's particles of AutoSurrogateLikelihoodDAIS (K=2) on
# sum_model and of the two batched guides on batched_model (their step size
# decays from 0.1, so that 100 steps reach the optimum and settle there);
# those tests' gate.  In a CPU rehearsal over five seeds the largest gaps
# were 0.154 (surrogate) and 0.162 (batched)
SMALL_GUIDES = {"surrogate": (150, 0.05, 4), "batched_mvn": (100, "decay", 4),
                "batched_lowrank": (100, "decay", 4)}
SMALL_GATE = 0.3


_T0 = time.perf_counter()


def log(msg):
    """Print a progress line with the seconds since the script began."""
    print(f"[+{time.perf_counter() - _T0:.0f}s] {msg}", flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_data(device):
    """Synthetic covtype-shape data, as bench.py builds it, all in numpy."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D - 1), dtype=np.float32)
    true_w = (0.5 * rng.standard_normal(D)).astype(np.float32)
    X = np.concatenate([x, np.ones((N, 1), np.float32)], axis=1)
    p = 1.0 / (1.0 + np.exp(-(X @ true_w)))
    y = (rng.random(N) < p).astype(np.float32)
    w_chains = (true_w + 0.1 * rng.standard_normal((CHAINS, D))).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(X), to(y), true_w, to(w_chains)


def cuda_ms(fn, reps=10):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound_ms(mode, b, d_pad, n_pad):
    """The least time the card could take for one call: the larger of its
    operations over the peak rate of their type and its bytes over the memory
    rate.  f32 mode's products can be made as two f32 products outside the
    tensor cores or as twelve products of bf16 pieces on them; the bound is the
    cheaper route.  Returns (ms, "operations" or "bytes")."""
    flops, nbytes = glm.glm_work(mode, b, d_pad, n_pad)
    by_ops = glm.glm_tensor_core_flops(mode, b, d_pad, n_pad) / PEAK_BF16 * 1e3
    if mode == "f32":
        by_ops = min(by_ops, flops / PEAK_F32 * 1e3)
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def compare(w, data):
    """Kernel against plain version on the same inputs, and the kernel twice:
    loglik max rel err, gradient max abs err, the least gradient atol that
    would pass beside ``G_RTOL``, and whether two calls gave the same bits."""
    ll_k, g_k = glm.glm_value_and_grad(w, data)
    ll_2, g_2 = glm.glm_value_and_grad(w, data)
    ll_p, g_p = glm.plain_value_and_grad(w, data)
    torch.cuda.synchronize()
    err = (g_k - g_p).abs()
    return {
        "finite": torch.isfinite(ll_k).all().item() and torch.isfinite(g_k).all().item(),
        "ll_rel": ((ll_k - ll_p).abs() / ll_p.abs()).max().item(),
        "g_abs": err.max().item(),
        "g_max": g_p.abs().max().item(),
        "atol_needed": (err - G_RTOL * g_p.abs()).max().item(),
        "same_bits": torch.equal(ll_k, ll_2) and torch.equal(g_k, g_2),
    }


def check_kernel(name, w, data, what):
    """``compare`` held to the tolerances; returns its readings."""
    got = compare(w, data)
    atol = glm.kernel_tolerances(data.mode, data.n)[2]
    log(f"[kernels] {name} at {what}: loglik max rel err {got['ll_rel']:.3e} (rtol {LL_RTOL}), "
        f"grad max abs err {got['g_abs']:.3e} on components up to {got['g_max']:.3e} "
        f"(rtol {G_RTOL}, atol {atol:.3e}; the least atol that passes: {got['atol_needed']:.3e})")
    if not got["same_bits"]:
        raise SystemExit(f"{name} at {what}: two calls gave different bits")
    if not (got["finite"] and got["ll_rel"] <= LL_RTOL and got["atol_needed"] <= atol):
        raise SystemExit(f"{name} at {what} disagrees with its plain version")
    return got


def ragged_problem(device):
    n, d, c = RAGGED
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w0 = (0.3 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w0))).astype(np.float32)
    W = (w0 + 0.05 * rng.standard_normal((c, d))).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(X), to(y), to(W)


def phase_kernels(X, y, w_chains):
    results = {}
    Xr, yr, Wr = ragged_problem(X.device)
    for name, (mode, replaces) in KERNELS.items():
        ragged = glm.prepare_glm_data(Xr, yr, dtype=mode)
        check_kernel(name, Wr, ragged, "%d x %d, %d chains" % RAGGED)
        del ragged
        data = glm.prepare_glm_data(X, y, dtype=mode)
        d_pad, n_pad = data.x_t.shape
        got = check_kernel(name, w_chains, data, f"{N} x {D}, {CHAINS} chains")
        ms = cuda_ms(lambda: glm.glm_value_and_grad(w_chains, data))
        plain_ms = cuda_ms(lambda: glm.plain_value_and_grad(w_chains, data))
        bound, bound_by = bound_ms(data.mode, CHAINS, d_pad, n_pad)
        log(
            f"[kernels] {name}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms by {bound_by} "
            f"(share of bound {bound / ms:.3f}) at C={CHAINS}, D_pad={d_pad}, N_pad={n_pad}"
        )
        if ms < bound:
            raise SystemExit(f"{name} took {ms:.3f} ms, less than its bound of {bound:.3f} ms")
        results[name] = {
            "name": name,
            "route": "cuda",
            "source": "numpyro_tpu_torch/csrc/glm.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": got["g_abs"],
            "loglik_max_rel_err": got["ll_rel"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "share_of_bound": bound / ms,
            "library_ms": None,  # no one PyTorch call computes loglik and gradient
            "instruction": "wgmma",
        }
        if name == "glm_split":
            # how the kernel scales with the chain count (kernel only: the
            # plain version's logits at 1,024 chains would take 2.4 GB apiece)
            rng = np.random.default_rng(4)
            for chains in SWEEP_CHAINS:
                w = w_chains[:1] + torch.from_numpy(
                    (0.1 * rng.standard_normal((chains, D))).astype(np.float32)).to(X.device)
                t = cuda_ms(lambda: glm.glm_value_and_grad(w, data))
                b_ms, _ = bound_ms(data.mode, chains, d_pad, n_pad)
                log(f"[kernels] glm_split at {chains} chains: {t:.3f} ms "
                    f"(bound {b_ms:.3f} ms, share {b_ms / t:.3f})")
                results[name][f"ms_at_{chains}_chains"] = t
        del data
    torch.cuda.empty_cache()
    return results


def model(data, loglik=glm.bernoulli_logits_loglik):
    """The covtype model; ``loglik`` is the plain version's op only in the
    check of an ELBO gradient against the plain version (phase 8)."""
    w = npt.sample(
        "w", dist.Normal(torch.zeros(D, device=data.device), 1.0).to_event(1)
    )
    npt.factor("lik", loglik(w, data))


def phase_main(X, y, true_w, name, run=None, tag="main", **nuts_kw):
    """One MCMC(NUTS) run in the mode of kernel ``name`` (``run``: warmup,
    samples, depth, gate; ``RUNS[name]`` by default); returns its stats."""
    warmup, samples, depth, gate = RUNS[name] if run is None else run
    data = glm.prepare_glm_data(X, y, dtype=KERNELS[name][0])
    mcmc = MCMC(
        NUTS(model, max_tree_depth=depth, **nuts_kw),
        num_warmup=warmup,
        num_samples=samples,
        num_chains=CHAINS,
        chain_method="vectorized",
    )
    before = glm.launch_counts[name]
    mcmc.run(torch.Generator(device=X.device).manual_seed(1), data,
             extra_fields=("num_steps",))
    stats = mcmc.last_run_stats
    launches = glm.launch_counts[name] - before
    draws = mcmc.get_samples(group_by_chain=True)["w"]
    if draws.shape != (CHAINS, samples, D) or not torch.isfinite(draws).all():
        raise SystemExit(f"{name}: bad draws, shape {tuple(draws.shape)}")
    w_err = (draws.mean((0, 1)).cpu() - torch.from_numpy(true_w)).abs().max().item()
    flat = draws.reshape(-1, D).double()
    stats["posterior"] = {"mean": flat.mean(0), "std": flat.std(0), "cov": torch.cov(flat.T)}
    ess = effective_sample_size(draws)
    leapfrogs = int(mcmc.get_extra_fields()["num_steps"].sum().item())
    stats["ms_per_eval"] = (stats["warmup_s"] + stats["sample_s"]) / (
        stats["potential_evals_warmup"] + stats["potential_evals_sample"]) * 1e3
    log(
        f"[{tag}] {name}: {warmup} + {samples} transitions, max_tree_depth {depth}; "
        f"warmup {stats['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} s, "
        f"init {stats['init_s']:.2f} s; potential evaluations {stats['potential_evals']} "
        f"(warmup {stats['potential_evals_warmup']}, sampling "
        f"{stats['potential_evals_sample']}) + {stats['init_traces']} init trace; "
        f"{name} launches {launches}; "
        f"leapfrogs counted in draws {leapfrogs}; ESS median "
        f"{ess.median().item():.1f} (min {ess.min().item():.1f}); "
        f"max |mean(w) - true_w| {w_err:.4f}; {stats['ms_per_eval']:.2f} ms per evaluation"
    )
    # one launch per batched potential evaluation, plus the one unbatched
    # model trace with which initialization finds the latent sites
    if launches != stats["potential_evals"] + stats["init_traces"]:
        raise SystemExit(
            f"{name} launched {launches} times for {stats['potential_evals']} "
            f"potential evaluations and {stats['init_traces']} init trace(s)"
        )
    if gate is not None and not w_err < gate:
        raise SystemExit(f"{name}: posterior means off by {w_err:.4f} (>= {gate})")
    return stats


def phase_per_step(X, y, checkpoint_path):
    """NUTS in split mode through the per-step API (a field that the fused
    run does not bank sends ``MCMC`` there): one launch per evaluation.
    Warmup runs first and its ``post_warmup_state`` is saved to
    ``checkpoint_path`` before sampling resumes from it in memory (phase 22a
    resumes from the file); returns what 22a needs: the data, the kernel,
    the state as a target to restore onto, the saved generator state, and
    the sampling run's draws and potential energies."""
    chains, warmup, samples, depth = PER_STEP
    data = glm.prepare_glm_data(X, y, dtype="split")
    mcmc = MCMC(NUTS(model, max_tree_depth=depth), num_warmup=warmup, num_samples=samples,
                num_chains=chains)
    before = glm.launch_counts["glm_split"]
    mcmc.warmup(2, data)
    warm = mcmc.last_run_stats
    save_checkpoint(checkpoint_path, mcmc.post_warmup_state)
    rng_state = mcmc.post_warmup_state.rng_key.get_state()
    mcmc.run(2, data, extra_fields=("potential_energy",))
    stats = mcmc.last_run_stats
    launches = glm.launch_counts["glm_split"] - before
    draws = mcmc.get_samples(group_by_chain=True)["w"]
    pe = mcmc.get_extra_fields(group_by_chain=True)["potential_energy"]
    evals = warm["potential_evals"] + stats["potential_evals"]
    log(f"[main] per-step NUTS, {chains} chains, {warmup} + {samples} (sampling resumed from "
        f"post_warmup_state): {evals} potential evaluations, glm_split launches {launches}, "
        f"warmup {warm['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} s")
    if draws.shape != (chains, samples, D) or not torch.isfinite(draws).all():
        raise SystemExit(f"per-step NUTS: bad draws, shape {tuple(draws.shape)}")
    if pe.shape != (chains, samples) or not torch.isfinite(pe).all():
        raise SystemExit("per-step NUTS: bad collected potential energies")
    if "init_s" not in warm or launches != evals + 1:
        raise SystemExit(
            f"per-step NUTS launched glm_split {launches} times for "
            f"{evals} potential evaluations and 1 init trace"
        )
    return {"path": checkpoint_path, "data": data, "kernel": mcmc.sampler,
            "target": mcmc.post_warmup_state,
            "rng_state": rng_state, "draws": draws, "pe": pe}


def model_ecs(X, y, size=None):
    """The subsampled covtype model; ``size``: the whole data's rows, which a
    rank's data shard (``parallel.shard_data``) holds only part of."""
    w = npt.sample("w", dist.Normal(torch.zeros(D, device=X.device), 1.0).to_event(1))
    with npt.plate("N", X.shape[0] if size is None else size, subsample_size=SUBSAMPLE):
        xb = npt.subsample(X, event_dim=1)
        yb = npt.subsample(y, event_dim=0)
        npt.sample("obs", dist.Bernoulli(logits=xb @ w), obs=yb)


def phase_ecs(X, y, true_w, config, panel_mode="auto", proxy_mode="auto", expect=None,
              anchor=None):
    """One MCMC(HMCECS(NUTS)) run with the Taylor proxy at ``anchor`` (the
    generating coefficients by default); returns its stats."""
    chains, warmup, samples, depth, gate = config
    kernel = HMCECS(
        NUTS(model_ecs, max_tree_depth=depth),
        num_blocks=NUM_BLOCKS,
        proxy=HMCECS.taylor_proxy({"w": true_w if anchor is None else anchor}, mode=proxy_mode),
        panel_mode=panel_mode,
    )
    mcmc = MCMC(kernel, num_warmup=warmup, num_samples=samples, num_chains=chains,
                chain_method="vectorized")
    torch.cuda.reset_peak_memory_stats()
    launches0 = dict(glm.launch_counts)
    mcmc.run(1, X, y, extra_fields=("accept_prob",))
    stats = dict(mcmc.last_run_stats)
    tag = (f"[ecs] {chains} chains, panel_mode={panel_mode}, proxy mode={proxy_mode}"
           + ("" if anchor is None else ", proxy at phase 8d's MAP"))
    draws = mcmc.get_samples(group_by_chain=True)["w"]
    if draws.device.type != "cuda":
        raise SystemExit(f"{tag}: the run was not on the GPU")
    if draws.shape != (chains, samples, D) or not torch.isfinite(draws).all():
        raise SystemExit(f"{tag}: bad draws, shape {tuple(draws.shape)}")
    w_err = (draws.mean((0, 1)).cpu() - torch.from_numpy(true_w)).abs().max().item()
    block_accept = mcmc.get_extra_fields()["accept_prob"].mean().item()
    idx = mcmc.last_state.z["N"]
    ess = effective_sample_size(draws)
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    stats.update(
        w_err=w_err, block_accept=block_accept, modes=dict(kernel.resolved_modes),
        peak_bytes=torch.cuda.max_memory_allocated(), ess_median=ess.median().item(),
        ms_per_eval=(stats["warmup_s"] + stats["sample_s"]) / evals * 1e3,
    )
    log(
        f"{tag}: resolved {stats['modes']}; {warmup} + {samples} transitions, depth {depth}, "
        f"subsample {SUBSAMPLE} of {N}, {NUM_BLOCKS} blocks; init {stats['init_s']:.2f} s, "
        f"warmup {stats['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} s; potential "
        f"evaluations init {stats['potential_evals_init']}, warmup "
        f"{stats['potential_evals_warmup']}, sampling {stats['potential_evals_sample']} "
        f"({stats['potential_evals_warmup'] / warmup:.1f} / "
        f"{stats['potential_evals_sample'] / samples:.1f} per transition); "
        f"{stats['ms_per_eval']:.2f} ms per evaluation; block-accept rate {block_accept:.3f}; "
        f"ESS median {stats['ess_median']:.1f} (min {ess.min().item():.1f}); "
        f"max |mean(w) - true_w| {w_err:.4f}; peak memory "
        f"{stats['peak_bytes'] / 2**30:.2f} GiB"
    )
    if expect is not None and stats["modes"] != expect:
        raise SystemExit(f"{tag}: resolved {stats['modes']}, expected {expect}")
    if not 0.0 < block_accept < 1.0:
        raise SystemExit(f"{tag}: block-accept rate {block_accept}")
    if idx.shape != (chains, SUBSAMPLE) or torch.equal(idx[0], idx[1]):
        raise SystemExit(f"{tag}: the chains do not carry index panels of their own")
    if launches0 != dict(glm.launch_counts):
        raise SystemExit(f"{tag}: the subsampling path launched a GLM kernel")
    if not w_err < gate:
        raise SystemExit(f"{tag}: posterior means off by {w_err:.4f} (>= {gate})")
    return stats


def phase_fused(X, y):
    """One batched potential evaluation per fused-kernel mode, held against
    the plain version (these launches are not the main path's)."""
    gen = torch.Generator(device=X.device).manual_seed(3)
    z = {"w": 0.1 * torch.randn((CHAINS, D), generator=gen, device=X.device)}
    layout = FlatLayout({"w": z["w"][0]})
    for name, mode in (("glm_fused_f32", torch.float32), ("glm_fused_bf16", torch.bfloat16)):
        data = glm.prepare_glm_data(X, y, dtype=mode)
        pe_fn, _ = infer_util.get_potential_fn(model, {}, model_args=(data,))
        pe_grad = batched_potential(pe_fn, layout)
        before = dict(glm.launch_counts)
        pe, grad = pe_grad(layout.ravel_batch(z))
        torch.cuda.synchronize()
        launched = glm.launch_counts[name] - before[name]
        ll_p, g_p = glm.plain_value_and_grad(z["w"], data)
        prior = dist.Normal(torch.zeros(D, device=X.device), 1.0).to_event(1)
        pe_ref = -(ll_p + prior.log_prob(z["w"]))
        g_ref = -(g_p - z["w"])
        pe_rel = ((pe - pe_ref).abs() / pe_ref.abs()).max().item()
        log(
            f"[fused] {name}: one batched evaluation launched it {launched} "
            f"time(s); potential max rel err vs plain {pe_rel:.3e}"
        )
        if launched != 1 or pe_rel > LL_RTOL:
            raise SystemExit(f"{name} model path failed")
        # a gradient component sums 581k signed terms: two f32 summation
        # orders leave ~1e-7 of the largest component on every component, so
        # near-zero components get an atol scaled by it (5e-7 of it measured
        # on an H100)
        g_atol = 2e-6 * g_ref.abs().max().item()
        g_err = (grad - g_ref).abs().max().item()
        log(f"[fused] {name}: model gradient max abs err {g_err:.3e} "
            f"(rtol {G_RTOL}, atol {g_atol:.3e})")
        if not torch.allclose(grad, g_ref, rtol=G_RTOL, atol=g_atol):
            raise SystemExit(f"{name} model gradient disagrees with the plain version")
        del data


def gauss_problem(device):
    """The correlated Gaussian of tests/infer/test_mcmc.py:36-58: its
    covariance (numpy, f64) and the potential of one chain."""
    a = np.random.RandomState(0).randn(GAUSS_DIM, GAUSS_DIM)
    cov = a @ a.T + 0.1 * np.eye(GAUSS_DIM)
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32)).to(device)
    return cov, lambda z: 0.5 * z["z"] @ prec @ z["z"]


def phase_dense_gauss(device):
    """7a: NUTS under a dense mass on the correlated Gaussian."""
    chains, warmup, samples, depth = GAUSS_RUN
    cov, potential = gauss_problem(device)
    mcmc = MCMC(NUTS(potential_fn=potential, dense_mass=True, max_tree_depth=depth),
                num_warmup=warmup,
                num_samples=samples, num_chains=chains)
    mcmc.run(7, init_params={"z": torch.zeros((chains, GAUSS_DIM), device=device)})
    stats = mcmc.last_run_stats
    draws = mcmc.get_samples()["z"].double().cpu().numpy()
    mean_err = np.abs(draws.mean(0)).max()
    std_rel = np.abs(draws.std(0) / np.sqrt(np.diag(cov)) - 1).max()
    inv = mcmc.last_state.adapt_state.inverse_mass_matrix
    frob = np.linalg.norm(inv.double().mean(0).cpu().numpy() - cov) / np.linalg.norm(cov)
    log(f"[dense] 7a Gaussian, {chains} chains, {warmup} + {samples}: warmup "
        f"{stats['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} s, potential evaluations "
        f"{stats['potential_evals']}; max |mean| {mean_err:.4f} (gate 0.3), max |std / "
        f"sqrt(diag cov) - 1| {std_rel:.4f} (gate 0.15); mean adapted inverse mass "
        f"{tuple(inv.shape)} off cov by {frob:.4f} (relative Frobenius)")
    if inv.shape != (chains, GAUSS_DIM, GAUSS_DIM) or not np.isfinite(draws).all():
        raise SystemExit("7a: bad inverse mass or draws")
    if not (mean_err < 0.3 and std_rel < 0.15):
        raise SystemExit("7a: the draws miss the correlated Gaussian")


def horseshoe_data(device):
    """``examples/horseshoe_regression.py::make_data`` at its defaults, in
    numpy; X and y in f32 on ``device``."""
    n, d, active = HS_DATA
    rng = np.random.RandomState(0)
    X = rng.randn(n, d)
    beta = np.zeros(d)
    beta[:active] = rng.randn(active) * 2.0
    y = X @ beta + 0.5 * rng.randn(n)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return to(X), to(y), beta


def model_horseshoe(X, y):
    """``examples/horseshoe_regression.py::model``."""
    d = X.shape[1]
    tau = npt.sample("tau", dist.HalfCauchy(0.1))
    with npt.plate("D", d):
        lam = npt.sample("lambda", dist.HalfCauchy(1.0))
    sigma = npt.sample("sigma", dist.HalfNormal(1.0))
    with npt.plate("D2", d):
        beta = npt.sample("beta", dist.Normal(0.0, tau * lam))
    with npt.plate("N", X.shape[0]):
        npt.sample("y", dist.Normal(X @ beta, sigma), obs=y)


# phase 15a, the SKIM sparse regression of examples/sparse_regression.py at the
# example's widths: data (N, P, S) from get_data with seed 0 and the
# hyperparameters of its main (:118-125)
SKIM_DATA = (100, 20, 3)
SKIM_HYPERS = {"expected_sparsity": 2.0, "alpha1": 3.0, "beta1": 1.0, "alpha2": 3.0,
               "beta2": 1.0, "alpha3": 1.0, "c": 1.0}
# chains, warmup, samples, tree depths in warmup and sampling, cut from the
# example's 1 x (500 + 500) at depth 7 to fit phase 15's budget: trees fill
# their cap (7.2 evaluations a transition), and 64 chains give 640 draws.
# 40 + 10 took 7.6 s of the script's 13.4 s phase 15 on the card, so 30 + 10,
# at which CPU rehearsals with seeds 1-4 found {0, 1, 2} (gaps 0.008-0.036)
SKIM_RUN = (64, 30, 10, (3, 3))
# the singleton means of the active dimensions within max(2e, e + 0.05) of the
# generating ones, the rule of HS_GATE, for e = 0.0194, the largest gap over
# keys 0-2 of the JAX package's own run at SKIM_RUN (0.0109, 0.0194, 0.0079),
# each finding exactly {0, 1, 2} (`JAX_PLATFORMS=cpu python3 -m
# dev.skim_reference 64 30 10 3`; at 40 + 10, 0.0078)
SKIM_GATE = 0.0694

# phase 15b, AutoSemiDAIS on the model of
# tests/infer/test_autoguide_extra.py::test_auto_semi_dais: its data (the
# test's 16 values of 1.5 + 0.5 * normal(PRNGKey(0)), as the JAX package
# makes them), N, subsample size, K, Adam step size, steps (cut from the
# test's 700 to fit the budget: 100 took 4.4 s in the script on the card, so
# 70) and draws of sample_posterior.  The global AutoNormal starts at theta =
# 0 (init_to_value, so that runs differ only in their noise).  The gate is
# the test's criterion (finite losses, the last 50 below the first 3) and the
# mean of theta within max(2e, e + 0.05) of the JAX package's own run at this
# configuration, key 0 (0.3348), e = 0.0073 the largest gap of keys 1-4 to it
# (`JAX_PLATFORMS=cpu python3 -m dev.semi_dais_reference 70`; at 100 steps
# 0.4638, e = 0.0070)
SEMI_DATA = [2.3113210201263428, 2.512632369995117, 1.2832027673721313, 1.4606913328170776,
             1.5880454778671265, 1.0139553546905518, 1.2523505687713623, 1.7471892833709717,
             1.8321746587753296, 1.0249183177947998, 2.5897650718688965, 0.5224246978759766,
             1.6792854070663452, 1.5788975954055786, 2.138542413711548, 2.255232334136963]
SEMI_RUN = (16, 8, 3, 5e-3, 70, 1000)
SEMI_GATE = {"theta": 0.3348, "gate": 0.0573}
# phase 15c, the new families on the card: each class's parameters (three
# values each, around the cases of tests/test_distributions.py), their
# log_prob, cdf and icdf on CUDA tensors against the same calls on CPU
# tensors, to rtol 1e-4 and atol 1e-6 (the card's lgamma, digamma, erfc and
# pow round differently in the last bits, and a bisected icdf can move its
# last halving); Gamma and Beta draws from a CUDA generator (20,000 each),
# their means and variances within 4 standard errors; draws of each inside
# its support (TruncatedNormal's window stays out of the far right tail, where
# the two-sided truncation, the JAX package's as well, quantizes its float32
# draws and can land below low: ROADMAP.md, Queue 3)
FAMILIES = {
    "Gamma": dict(concentration=(2.0, 0.5, 5.0), rate=(3.0, 1.0, 0.5)),
    "Chi2": dict(df=(4.0, 1.5, 9.0)),
    "InverseGamma": dict(concentration=(3.0, 4.5, 6.0), rate=(2.0, 1.0, 0.5)),
    "Beta": dict(concentration1=(1.5, 0.7, 5.0), concentration0=(2.5, 3.0, 0.9)),
    "BetaProportion": dict(mean=(0.4, 0.2, 0.7), concentration=(5.0, 10.0, 2.0)),
    "LogNormal": dict(loc=(0.5, -0.2, 1.0), scale=(0.8, 0.3, 1.5)),
    "LogUniform": dict(low=(1.0, 0.5, 2.0), high=(5.0, 3.0, 9.0)),
    "Laplace": dict(loc=(0.5, -1.0, 2.0), scale=(2.0, 0.5, 1.0)),
    "Gumbel": dict(loc=(0.5, -1.0, 2.0), scale=(2.0, 0.5, 1.0)),
    "Logistic": dict(loc=(0.5, -1.0, 2.0), scale=(1.1, 0.5, 2.0)),
    "SoftLaplace": dict(loc=(0.0, -1.0, 2.0), scale=(1.0, 0.5, 2.0)),
    "AsymmetricLaplace": dict(loc=(0.5, -1.0, 0.0), scale=(1.2, 0.5, 2.0),
                              asymmetry=(0.7, 1.5, 1.0)),
    "AsymmetricLaplaceQuantile": dict(loc=(0.0, 1.0, -1.0), scale=(1.0, 0.5, 2.0),
                                      quantile=(0.3, 0.5, 0.8)),
    "Pareto": dict(scale=(1.5, 0.5, 2.0), alpha=(3.0, 5.0, 2.5)),
    "Weibull": dict(scale=(1.5, 0.5, 2.0), concentration=(2.0, 0.8, 4.0)),
    "Kumaraswamy": dict(concentration1=(2.0, 0.5, 4.0), concentration0=(3.0, 1.5, 0.7)),
    "Gompertz": dict(concentration=(1.5, 0.3, 4.0), rate=(0.8, 2.0, 0.5)),
    "Levy": dict(loc=(0.0, 1.0, 0.5), scale=(1.0, 0.5, 2.0)),
    "RelaxedBernoulliLogits": dict(temperature=(0.7, 0.3, 1.5), logits=(0.4, -1.0, 2.0)),
    "TruncatedNormal": dict(loc=(0.5, 0.0, -1.0), scale=(1.0, 1.0, 2.0), low=(-1.0, 0.5, -2.0),
                            high=(2.0, 3.0, 0.0)),
    "TruncatedCauchy": dict(loc=(0.0, 1.0, -1.0), scale=(1.0, 0.5, 2.0), low=(-2.0, 0.0, -4.0)),
    "LowerTruncatedPowerLaw": dict(alpha=(-2.5, -1.5, -4.0), low=(0.5, 1.0, 2.0)),
    "DoublyTruncatedPowerLaw": dict(alpha=(-2.0, -1.0, 0.5), low=(0.5, 1.0, 0.1),
                                    high=(3.0, 10.0, 2.0)),
}
FAMILY_RTOL, FAMILY_ATOL = 1e-4, 1e-6


def skim_data(n=100, p=20, s=3, sigma_obs=0.05, seed=0):
    """``examples/sparse_regression.py::get_data``, in numpy."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, p)
    W = 0.5 + 2.5 * rng.rand(s)
    Y = X[:, :s] @ W + W[0] * X[:, 0] * X[:, 1] + sigma_obs * rng.randn(n)
    Y -= Y.mean()
    return X.astype(np.float32), (Y / Y.std()).astype(np.float32), W / Y.std()


def quad_kernel(X, Z, eta1, eta2, c, jitter=1e-4):
    """``examples/sparse_regression.py::quad_kernel``, batched over the
    leading dims of X, Z and the scalars (the draws of phase 15a's
    post-processing)."""
    xz = X @ Z.transpose(-2, -1)
    k = 0.5 * eta2[..., None, None] ** 2 * (1.0 + xz) ** 2
    k = k - 0.5 * eta2[..., None, None] ** 2 * (X**2) @ (Z**2).transpose(-2, -1)
    k = k + (eta1[..., None, None] ** 2 - eta2[..., None, None] ** 2) * xz
    k = k + c**2 - 0.5 * eta2[..., None, None] ** 2
    if X is Z:
        k = k + jitter * torch.eye(X.shape[-2], dtype=X.dtype, device=X.device)
    return k


def skim_model(X, Y, hypers):
    """``examples/sparse_regression.py::model``: the SKIM kernel of the
    hyperparameters, an ``(N, N)`` covariance a chain, factored by
    ``MultivariateNormal`` (NaN where it is not positive definite)."""
    S, P, N = hypers["expected_sparsity"], X.shape[1], X.shape[0]
    sigma = npt.sample("sigma", dist.HalfNormal(hypers["alpha3"]))
    phi = sigma * (S / np.sqrt(N)) / (P - S)
    eta1 = npt.sample("eta1", dist.HalfCauchy(phi))
    msq = npt.sample("msq", dist.InverseGamma(hypers["alpha1"], hypers["beta1"]))
    xisq = npt.sample("xisq", dist.InverseGamma(hypers["alpha2"], hypers["beta2"]))
    lam = npt.sample("lambda", dist.HalfCauchy(1.0).expand([P]).to_event(1))
    eta2 = eta1**2 * torch.sqrt(xisq) / msq
    kappa = torch.sqrt(msq) * lam / torch.sqrt(msq + (eta1 * lam) ** 2)
    kX = kappa * X
    k = quad_kernel(kX, kX, eta1, eta2, hypers["c"]) + sigma**2 * torch.eye(N, device=X.device)
    npt.sample("Y", dist.MultivariateNormal(torch.zeros(N, device=X.device), covariance_matrix=k),
               obs=Y)


def skim_singleton_stats(X, Y, c, draws):
    """``examples/sparse_regression.py::singleton_stats`` for a batch of
    draws at once (no vmap): the posterior mean and variance of every
    singleton effect theta_i, by one GP conditional at the probes +-e_i,
    with ``torch.linalg.cholesky`` and ``cholesky_solve``."""
    P, N = X.shape[1], X.shape[0]
    eta1, msq, xisq = draws["eta1"], draws["msq"], draws["xisq"]
    lam, sigma = draws["lambda"], draws["sigma"]
    eta2 = eta1**2 * torch.sqrt(xisq) / msq
    kappa = torch.sqrt(msq)[:, None] * lam / torch.sqrt(msq[:, None] + (eta1[:, None] * lam) ** 2)
    eye = torch.eye(P, dtype=X.dtype, device=X.device)
    probes = torch.cat([eye, -eye])
    kX = kappa[:, None, :] * X
    kprobe = kappa[:, None, :] * probes
    k_xx = quad_kernel(kX, kX, eta1, eta2, c) + (sigma**2)[:, None, None] * torch.eye(
        N, dtype=X.dtype, device=X.device)
    chol = torch.linalg.cholesky(k_xx)
    k_px = quad_kernel(kprobe, kX, eta1, eta2, c)
    mean_at_probes = (k_px @ torch.cholesky_solve(
        torch.broadcast_to(Y[:, None], (len(eta1), N, 1)), chol))[..., 0]
    mu = 0.5 * (mean_at_probes[:, :P] - mean_at_probes[:, P:])
    k_pp = quad_kernel(kprobe, kprobe, eta1, eta2, c)
    cov = k_pp - k_px @ torch.cholesky_solve(k_px.transpose(-2, -1), chol)
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)
    var = 0.25 * (diag[:, :P] + diag[:, P:] - 2.0 * torch.diagonal(cov[:, :P, P:], dim1=-2,
                                                                    dim2=-1))
    return mu, var


def skim_posterior(X, Y, samples):
    """The example's summary of the draws: the singleton means and their
    stds as a mixture over the draws, in chunks of 512 draws; returns
    (mean, std, active dims by the 3-std rule)."""
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])).double() for k, v in samples.items()}
    n = flat["sigma"].shape[0]
    mus, variances = [], []
    Xd, Yd = X.double(), Y.double()
    for lo in range(0, n, 512):
        chunk = {k: v[lo:lo + 512] for k, v in flat.items()}
        mu, var = skim_singleton_stats(Xd, Yd, SKIM_HYPERS["c"], chunk)
        mus.append(mu)
        variances.append(var)
    mus, variances = torch.cat(mus), torch.cat(variances)
    mean = mus.mean(0)
    std = torch.sqrt((variances + mus**2).mean(0) - mean**2)
    active = torch.nonzero(mean.abs() > 3 * std).flatten().tolist()
    return mean.cpu().numpy(), std.cpu().numpy(), active


def phase_skim(device):
    """15a: NUTS with vectorized chains on SKIM; returns its wall seconds."""
    t0 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    n, p, s = SKIM_DATA
    X_np, Y_np, expected = skim_data(n, p, s)
    X, Y = torch.from_numpy(X_np).to(device), torch.from_numpy(Y_np).to(device)
    chains, warmup, samples, depth = SKIM_RUN
    mcmc = MCMC(NUTS(skim_model, max_tree_depth=depth), num_warmup=warmup,
                num_samples=samples, num_chains=chains, device=device)
    mcmc.run(15, X, Y, SKIM_HYPERS)
    stats = mcmc.last_run_stats
    divergent = stats["num_divergent_warmup"]
    z = mcmc.get_samples(group_by_chain=True)
    if not all(torch.isfinite(v).all() for v in z.values()):
        raise SystemExit("15a: draws that are not finite")
    mean, std, active = skim_posterior(X, Y, z)
    gap = float(np.abs(mean[:s] - expected).max())
    evals_w = stats["potential_evals_warmup"]
    evals_s = stats["potential_evals_sample"]
    wall = time.perf_counter() - t0
    ms = (stats["warmup_s"] + stats["sample_s"]) / (evals_w + evals_s) * 1e3
    log(f"[skim] 15a SKIM (N {n}, P {p}, S {s}), {chains} chains, {warmup} + {samples}, "
        f"max_tree_depth {depth}: init {stats['init_s']:.2f} s; warmup {stats['warmup_s']:.2f} s "
        f"with {evals_w} evaluations ({evals_w / warmup:.1f} a transition) and {divergent} "
        f"divergent transitions of {chains * warmup}; sampling {stats['sample_s']:.2f} s with "
        f"{evals_s} evaluations "
        f"({evals_s / samples:.1f} a transition); {ms:.2f} ms per evaluation; active "
        f"dimensions {active}; singleton means {np.round(mean[:s], 4).tolist()} +- "
        f"{np.round(std[:s], 4).tolist()} against {np.round(expected, 4).tolist()}, gap "
        f"{gap:.4f} (gate {SKIM_GATE}); {wall:.2f} s")
    if active != list(range(s)):
        raise SystemExit(f"15a: identified active dimensions {active}, not {list(range(s))}")
    if not gap < SKIM_GATE:
        raise SystemExit(f"15a: the singleton means are off by {gap:.4f} (>= {SKIM_GATE})")
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("15a: the leg launched a GLM kernel")
    return wall


def semi_models(device):
    """The models of tests/infer/test_autoguide_extra.py::test_auto_semi_dais
    on ``device``: (model, local model, global model)."""
    n, sub = SEMI_RUN[:2]
    data = torch.tensor(SEMI_DATA, device=device)

    def global_model():
        return npt.sample("theta", dist.Normal(0.0, 3.0))

    def local_model(theta):
        with npt.plate("data", n, subsample_size=sub):
            tau = npt.sample("tau", dist.Gamma(5.0, 5.0))
            batch = npt.subsample(data, event_dim=0)
            npt.sample("obs", dist.Normal(theta, 1 / torch.sqrt(tau)), obs=batch)

    def model():
        return local_model(global_model())

    return model, local_model, global_model


def phase_semi_dais(device):
    """15b: AutoSemiDAIS with a global AutoNormal; returns its wall seconds."""
    t0 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    n, sub, K, lr, steps, draws = SEMI_RUN
    model, local_model, global_model = semi_models(device)
    start = init_to_value(values={"theta": torch.tensor(0.0, device=device)})
    guide = autoguide.AutoSemiDAIS(model, local_model,
                                   autoguide.AutoNormal(global_model, init_loc_fn=start), K=K)
    ts = time.perf_counter()
    res = SVI(model, guide, Adam(lr), Trace_ELBO(), device=device).run(151, steps)
    losses = res.losses.cpu().numpy()
    fit_s = time.perf_counter() - ts
    theta = guide.sample_posterior(torch.Generator(device=device).manual_seed(152), res.params,
                                   sample_shape=(draws,))["theta"]
    mean = theta.double().mean().item()
    with handlers.substitute(data={"data": torch.arange(sub, device=device)}):
        one = guide.sample_posterior(torch.Generator(device=device).manual_seed(153), res.params)
    gap = abs(mean - SEMI_GATE["theta"])
    criterion = bool(np.isfinite(losses[-50:]).all() and losses[-50:].mean() < losses[:3].mean())
    wall = time.perf_counter() - t0
    log(f"[semi] 15b AutoSemiDAIS (N {n}, subsample {sub}, K {K}), Adam({lr}), {steps} steps in "
        f"{fit_s:.2f} s ({fit_s / steps * 1e3:.2f} ms a step); loss {losses[:3].mean():.3f} -> "
        f"{losses[-50:].mean():.3f} (the test's criterion: {criterion}); mean of theta over "
        f"{draws} draws {mean:.4f} against the JAX package's {SEMI_GATE['theta']}, gap "
        f"{gap:.4f} (gate {SEMI_GATE['gate']}); {wall:.2f} s")
    if not criterion:
        raise SystemExit("15b: the losses are not finite or did not fall (the JAX test's "
                         "criterion)")
    if not (gap < SEMI_GATE["gate"] and tuple(one["tau"].shape) == (sub,)
            and torch.isfinite(one["theta"])):
        raise SystemExit(f"15b: theta's mean is off the JAX package's by {gap:.4f}, or the "
                         f"posterior draw has tau of shape {tuple(one['tau'].shape)}")
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("15b: the leg launched a GLM kernel")
    return wall


def _family(name, params, device):
    values = {k: torch.tensor(v, device=device) for k, v in params.items()}
    if name.startswith("Truncated"):
        bounds = {k: values.pop(k) for k in ("low", "high") if k in values}
        return getattr(dist, name)(**values, **bounds)
    return getattr(dist, name)(**values)


def phase_families(device):
    """15c: the new families' log_prob, cdf and icdf on CUDA tensors against
    CPU tensors, Gamma and Beta draws from a CUDA generator against their
    moments, and the bisected inverses timed; returns the wall seconds."""
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    q = torch.linspace(0.05, 0.95, 12).reshape(4, 3)
    worst, checked = 0.0, 0
    for name, params in FAMILIES.items():
        d_cpu, d_dev = _family(name, params, cpu), _family(name, params, device)
        x = d_cpu.sample(torch.Generator().manual_seed(154), (4,))
        for method, arg in (("log_prob", x), ("cdf", x), ("icdf", q)):
            try:
                want = getattr(d_cpu, method)(arg)
            except NotImplementedError:
                try:
                    getattr(d_dev, method)(arg.to(device))
                except NotImplementedError:
                    continue
                raise SystemExit(f"15c: {name}.{method} raises on the CPU only")
            got = getattr(d_dev, method)(arg.to(device))
            if got.device.type != device.type:
                raise SystemExit(f"15c: {name}.{method} came back on {got.device}")
            err = ((got.cpu() - want).abs() / (FAMILY_ATOL + FAMILY_RTOL * want.abs())).max()
            worst, checked = max(worst, err.item()), checked + 1
            if not err <= 1.0:
                raise SystemExit(f"15c: {name}.{method} on the card is off the CPU's: "
                                 f"{got.cpu().tolist()} against {want.tolist()}")
        draw = d_dev.sample(torch.Generator(device=device).manual_seed(155), (8,))
        if draw.device.type != device.type or not bool(d_dev.support(draw).all()):
            raise SystemExit(f"15c: {name}'s draws are off its support or its device")
    moments = {}
    for name in ("Gamma", "Beta"):
        d = _family(name, FAMILIES[name], device)
        n = 20_000
        x = d.sample(torch.Generator(device=device).manual_seed(156), (n,)).double()
        mean, var = d.mean.double(), d.variance.double()
        se_mean = torch.sqrt(var / n)
        se_var = torch.sqrt(((x - x.mean(0)) ** 4).mean(0) / n)
        z = max(((x.mean(0) - mean).abs() / se_mean).max().item(),
                ((x.var(0) - var).abs() / se_var).max().item())
        moments[name] = z
        if not z < 4.0:
            raise SystemExit(f"15c: {name}'s draws on the card are {z:.2f} standard errors off "
                             "their moments")
    a = torch.rand(4096, device=device) * 20 + 0.3
    b = torch.rand(4096, device=device) * 20 + 0.3
    y = torch.rand(4096, device=device)
    inv_beta_ms = cuda_ms(lambda: betaincinv(a, b, y), reps=1)
    inv_gamma_ms = cuda_ms(lambda: gammaincinv(a, y), reps=1)
    wall = time.perf_counter() - t0
    log(f"[families] 15c {len(FAMILIES)} classes, {checked} calls on the card within rtol "
        f"{FAMILY_RTOL}, atol {FAMILY_ATOL} of the CPU's (worst {worst:.3f} of the bound); Gamma "
        f"and Beta draws on a CUDA generator within {max(moments.values()):.2f} standard errors "
        f"of their moments (gate 4); betaincinv {inv_beta_ms:.2f} ms and gammaincinv "
        f"{inv_gamma_ms:.2f} ms on 4,096 elements (60 and 120 bisection steps, not gated); "
        f"{wall:.2f} s")
    return wall


def phase_fifteen(device):
    """Phase 15: SKIM, AutoSemiDAIS and the new families; returns the walls
    of its legs (15c only on the card)."""
    walls = {"15a": phase_skim(device), "15b": phase_semi_dais(device)}
    if device.type == "cuda":
        walls["15c"] = phase_families(device)
    return walls


# phase 16a, examples/ucbadmit.py at its full size: the 12-row table (dept,
# male, applications, admits) of examples/ucbadmit.py:16-20; chains, warmup,
# samples and (warmup, sampling) tree depths, cut from the example's 1 x
# (500 + 500) to fit phase 16's budget (40 + 20 took 3.7 s on an H100 80GB
# at 700 W, 8.5 ms an evaluation, `python3 -m dev.phase16 --sizing 64 40 20`,
# so 30 + 15).  The posterior mean of bm and the
# example's mean |predicted - observed admit rate| (Predictive on the draws)
# each within UCB_GATE of the JAX package's own run at this configuration,
# key 0, the gate max(2e, e + 0.05) for e = 0.0097, the largest gap of keys
# 1-4 to it (`JAX_PLATFORMS=cpu python3 -m dev.discrete_reference ucb`; at
# 40 + 20 the port read bm -0.0980, rate gap 0.0270 on that H100)
UCB_DATA = ((0, 1, 825, 512), (0, 0, 108, 89), (1, 1, 560, 353), (1, 0, 25, 17),
            (2, 1, 325, 120), (2, 0, 593, 202), (3, 1, 417, 138), (3, 0, 375, 131),
            (4, 1, 191, 53), (4, 0, 393, 94), (5, 1, 373, 22), (5, 0, 341, 24))
UCB_RUN = (64, 30, 15, (3, 3))
UCB_REF = {"bm": -0.0909, "rate_gap": 0.0273}
UCB_GATE = 0.0597
# phase 16b, examples/ssbvm_mixture.py at its full size: 200 angles from
# numpy's vonmises (seed 0), K = 2, the label c enumerated; the mean over
# draws of each draw's sorted loc_phi (sorting takes care of label
# switching) within SSBVM_GATE of the JAX package's run at this
# configuration, key 0, by the rule of UCB_GATE, e = 0.2374 (`dev.
# discrete_reference ssbvm`).  At 20 + 10 the chains are still leaving their
# starts (the data's modes are near -2 and 1), so runs spread: 256 chains
# keep the port's seeds within 0.11 of each other on a CPU, where 64 left
# 0.5 (JAX's keys spread as widely at either count).  The example runs 400 +
# 400 on one chain; 40 + 20 at 64 chains took 444 evaluations at 18.3 ms on
# an H100 80GB at 700 W (`dev.phase16 --sizing 64 40 20`), over phase 16's
# budget
SSBVM_N = 200
SSBVM_RUN = (256, 20, 10, (3, 3))
SSBVM_REF = (-1.3507, 1.1955)
SSBVM_GATE = 0.4747
# and, since that gate is wide, the enumerated potential and its gradient
# at SSBVM_POINTS unconstrained points (numpy, seed 168) on the card against
# the CPU's, at rtol SSBVM_RTOL (the gradient with an atol of SSBVM_RTOL
# times each site's largest component)
SSBVM_POINTS, SSBVM_RTOL = 8, 1e-4
# phase 16c, the new families on the card: each class's parameters (three
# values each, around the cases of tests/test_distributions.py and
# tests/test_distributions_sweep.py), their log_prob, cdf and icdf on CUDA
# tensors against CPU tensors to FAMILY_RTOL and FAMILY_ATOL (15c's
# tolerance); draws from a CUDA generator (GOF_DRAWS each) against their pmf
# or density by the port's gof at p > GOF_FAILURE_RATE
NEW_FAMILIES = {
    "BinomialProbs": dict(probs=(0.4, 0.2, 0.7), total_count=(10.0, 10.0, 10.0)),
    "BinomialLogits": dict(logits=(0.4, -1.0, 2.0), total_count=(7.0, 7.0, 7.0)),
    "DiscreteUniform": dict(low=(0.0, 1.0, -2.0), high=(5.0, 5.0, 5.0)),
    "MultinomialProbs": dict(probs=((0.2, 0.3, 0.5),), total_count=(6.0,)),
    "MultinomialLogits": dict(logits=((0.2, -0.1, 0.4),), total_count=(6.0,)),
    "Poisson": dict(rate=(3.5, 0.5, 20.0)),
    "GeometricProbs": dict(probs=(0.3, 0.7, 0.05)),
    "GeometricLogits": dict(logits=(-1.1, 0.5, 2.0)),
    "OrderedLogistic": dict(predictor=(0.5, -1.0, 2.0), cutpoints=((-1.0, 1.0),)),
    "NegativeBinomial2": dict(mean=(3.0, 0.5, 10.0), concentration=(2.0, 5.0, 0.7)),
    "ZeroInflatedPoisson": dict(gate=(0.3, 0.1, 0.6), rate=(2.0, 5.0, 0.5)),
    "ZeroInflatedProbs": dict(gate=(0.3, 0.1, 0.6), base_rate=(2.0, 5.0, 0.5)),
    "ZeroInflatedLogits": dict(gate_logits=(-0.8, 1.0, 0.0), base_rate=(2.0, 5.0, 0.5)),
    "BetaBinomial": dict(concentration1=(2.0, 0.5, 4.0), concentration0=(3.0, 1.5, 0.8),
                         total_count=(10.0, 10.0, 10.0)),
    "GammaPoisson": dict(concentration=(2.0, 0.5, 6.0), rate=(0.5, 1.0, 2.0)),
    "NegativeBinomialProbs": dict(total_count=(4.0, 1.5, 9.0), probs=(0.4, 0.2, 0.7)),
    "NegativeBinomialLogits": dict(total_count=(4.0, 1.5, 9.0), logits=(-0.4, 0.5, 1.0)),
    "DirichletMultinomial": dict(concentration=((1.0, 2.0, 3.0),), total_count=(8.0,)),
    "VonMises": dict(loc=(0.5, -2.0, 3.0), concentration=(2.0, 0.3, 40.0)),
    "ProjectedNormal": dict(concentration=((1.0, 0.5, -0.3), (0.0, 2.0, 1.0), (0.2, 0.1, 0.4))),
    "SineSkewed": dict(base_loc=((0.0, 1.0),), base_concentration=((2.0, 1.0),),
                       skewness=((0.3, -0.2), (0.1, 0.4), (-0.5, 0.2))),
    "SineBivariateVonMises": dict(phi_loc=(0.0, 1.0, -2.0), psi_loc=(0.5, 0.0, 1.0),
                                  phi_concentration=(2.0, 5.0, 0.5),
                                  psi_concentration=(3.0, 2.0, 1.0),
                                  correlation=(0.5, -1.0, 0.2)),
}
GOF_DRAWS, GOF_FAILURE_RATE = 20_000, 5e-3
# the samplers whose draws on the card go through the port's gof (name ->
# the class and its parameters): the binomial on both sides of its n p = 10
# switch, Poisson, a Multinomial's compositions, VonMises, the bivariate von
# Mises and Gamma
GOF_CASES = {
    "binomial n p = 2.4": ("BinomialProbs", dict(probs=0.2, total_count=12.0)),
    "binomial n p = 30": ("BinomialProbs", dict(probs=0.3, total_count=100.0)),
    "Poisson": ("Poisson", dict(rate=3.5)),
    "Multinomial": ("MultinomialProbs", dict(probs=(0.2, 0.3, 0.5), total_count=6.0)),
    "VonMises": ("VonMises", dict(loc=0.5, concentration=2.0)),
    "SineBivariateVonMises": ("SineBivariateVonMises",
                              dict(phi_loc=0.0, psi_loc=0.5, phi_concentration=2.0,
                                   psi_concentration=3.0, correlation=0.5)),
    "Gamma": ("Gamma", dict(concentration=2.0, rate=3.0)),
}


def ucb_model(dept, male, applications, admit=None):
    """``examples/ucbadmit.py``'s binomial GLMM with department intercepts."""
    sigma = npt.sample("sigma", dist.HalfNormal(1.0))
    with npt.plate("dept", 6):
        a_dept = npt.sample("a_dept", dist.Normal(0.0, sigma))
    a = npt.sample("a", dist.Normal(0.0, 2.0))
    bm = npt.sample("bm", dist.Normal(0.0, 1.0))
    logits = a + a_dept[dept] + bm * male
    with npt.plate("obs", dept.shape[0]):
        npt.sample("admit", dist.Binomial(applications, logits=logits), obs=admit)


def _mcmc_leg(tag, model, run, seed, *args):
    """NUTS with vectorized chains; returns the draws, the run's stats and
    the ms per evaluation."""
    chains, warmup, samples, depths = run
    mcmc = MCMC(NUTS(model, max_tree_depth=depths), num_warmup=warmup, num_samples=samples,
                num_chains=chains, device=args[0].device)
    mcmc.run(seed, *args)
    stats = mcmc.last_run_stats
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    ms = (stats["warmup_s"] + stats["sample_s"]) / evals * 1e3
    draws = mcmc.get_samples()
    if not all(torch.isfinite(v).all() for v in draws.values()):
        raise SystemExit(f"{tag}: draws that are not finite")
    return draws, stats, evals, ms


def phase_ucbadmit(device):
    """16a: NUTS on ucbadmit, then Predictive on the draws; returns its wall
    seconds and the seconds of Predictive."""
    t0 = time.perf_counter()
    table = np.array(UCB_DATA)
    dept = torch.tensor(table[:, 0], device=device)
    male, apps, admit = (torch.tensor(table[:, i], dtype=torch.float32, device=device)
                         for i in (1, 2, 3))
    draws, stats, evals, ms = _mcmc_leg("16a", ucb_model, UCB_RUN, 161, dept, male, apps, admit)
    tp = time.perf_counter()
    pred = Predictive(ucb_model, draws, device=device)(162, dept, male, apps)["admit"]
    if device.type == "cuda":
        torch.cuda.synchronize()
    predictive_s = time.perf_counter() - tp
    if not (pred.device.type == device.type and pred.dtype == torch.int64
            and bool(((pred >= 0) & (pred <= apps.long())).all())):
        raise SystemExit("16a: Predictive's counts are off their support or their device")
    rate_gap = ((pred.double().mean(0) - admit.double()) / apps.double()).abs().mean().item()
    bm = draws["bm"].double().mean().item()
    gaps = {"bm": abs(bm - UCB_REF["bm"]), "rate_gap": abs(rate_gap - UCB_REF["rate_gap"])}
    wall = time.perf_counter() - t0
    chains, warmup, samples, depths = UCB_RUN
    log(f"[discrete] 16a ucbadmit, {chains} chains, {warmup} + {samples}, depths {depths}: "
        f"{evals} evaluations in {stats['warmup_s'] + stats['sample_s']:.2f} s, {ms:.2f} ms per "
        f"evaluation; Predictive of {pred.shape[0]} draws x {pred.shape[1]} rows in "
        f"{predictive_s:.3f} s; bm {bm:.4f} (JAX {UCB_REF['bm']}), mean |predicted - observed "
        f"admit rate| {rate_gap:.4f} (JAX {UCB_REF['rate_gap']}), gaps "
        f"{gaps['bm']:.4f} and {gaps['rate_gap']:.4f} (gate {UCB_GATE}); {wall:.2f} s")
    if not max(gaps.values()) < UCB_GATE:
        raise SystemExit(f"16a: off the JAX package's run by {gaps} (gate {UCB_GATE})")
    return wall, ms, predictive_s


def ssbvm_angles(n=SSBVM_N):
    """``examples/ssbvm_mixture.py``'s data: numpy's von Mises, seed 0."""
    rng = np.random.RandomState(0)
    half = n // 2
    a = np.stack([rng.vonmises(-2.0, 8, half), rng.vonmises(2.0, 8, half)], 1)
    b = np.stack([rng.vonmises(1.0, 8, half), rng.vonmises(-1.0, 8, half)], 1)
    return np.concatenate([a, b]).astype(np.float32)


def ssbvm_model(angles, K=2):
    """``examples/ssbvm_mixture.py``'s von Mises mixture, ``c`` enumerated."""
    with npt.plate("mix", K):
        loc_phi = npt.sample("loc_phi", dist.VonMises(0.0, 0.5))
        loc_psi = npt.sample("loc_psi", dist.VonMises(0.0, 0.5))
        conc_phi = npt.sample("conc_phi", dist.Gamma(2.0, 0.5))
        conc_psi = npt.sample("conc_psi", dist.Gamma(2.0, 0.5))
    weights = npt.sample("weights", dist.Dirichlet(torch.ones(K, device=angles.device)))
    with npt.plate("obs", angles.shape[0]):
        c = npt.sample("c", dist.Categorical(weights), infer={"enumerate": "parallel"})
        npt.sample("phi", dist.VonMises(loc_phi[c], conc_phi[c]), obs=angles[:, 0])
        npt.sample("psi", dist.VonMises(loc_psi[c], conc_psi[c]), obs=angles[:, 1])


def phase_ssbvm(device):
    """16b: NUTS on the enumerated von Mises mixture; returns its wall
    seconds."""
    t0 = time.perf_counter()
    angles = torch.from_numpy(ssbvm_angles()).to(device)
    draws, stats, evals, ms = _mcmc_leg("16b", ssbvm_model, SSBVM_RUN, 163, angles)
    locs = draws["loc_phi"].sort(-1).values.double().mean(0).cpu().numpy()
    gap = float(np.abs(locs - np.array(SSBVM_REF)).max())
    wall = time.perf_counter() - t0
    chains, warmup, samples, depths = SSBVM_RUN
    log(f"[discrete] 16b ssbvm_mixture ({SSBVM_N} angles, K 2, c enumerated), {chains} chains, "
        f"{warmup} + {samples}, depths {depths}: {evals} evaluations in "
        f"{stats['warmup_s'] + stats['sample_s']:.2f} s, {ms:.2f} ms per evaluation; sorted "
        f"loc_phi means {np.round(locs, 4).tolist()} (JAX {list(SSBVM_REF)}), gap {gap:.4f} "
        f"(gate {SSBVM_GATE}); {wall:.2f} s")
    if not gap < SSBVM_GATE:
        raise SystemExit(f"16b: the sorted loc_phi means are off the JAX package's by {gap:.4f} "
                         f"(gate {SSBVM_GATE})")
    ssbvm_potential_check(angles)
    return wall, ms


def ssbvm_potential_check(angles):
    """16b's tight check: the enumerated model's potential and gradient at
    fixed unconstrained points on ``angles``' device against the CPU's."""
    pe_err, g_err, _, _ = potential_check("16b", ssbvm_model, angles, SSBVM_POINTS, SSBVM_RTOL,
                                          168)
    log(f"[discrete] 16b enumerated potential at {SSBVM_POINTS} points on {angles.device.type} "
        f"against the CPU: max rel err {pe_err:.2e}, gradient {g_err:.3f} of its atol "
        f"(rtol {SSBVM_RTOL})")


def new_family(name, params, device):
    """A class of 16c from its parameters, on ``device`` (``base_*``
    parameters make the base of a zero-inflated or sine-skewed class)."""
    values = {k: torch.tensor(v, device=device) for k, v in params.items()}
    if name.startswith("ZeroInflated") and "base_rate" in values:
        return getattr(dist, name)(dist.Poisson(values.pop("base_rate")), *values.values())
    if name == "SineSkewed":
        base = dist.VonMises(values["base_loc"], values["base_concentration"]).to_event(1)
        return dist.SineSkewed(base, values["skewness"])
    return getattr(dist, name)(**values)


def _gof_of(name, d, x):
    """The p-value of draws ``x`` of ``d`` (a scalar batch) against its pmf
    or density by the port's gof."""
    from numpyro_tpu_torch.distributions import gof

    x = x.cpu()
    if name.startswith("Multinomial"):
        from itertools import combinations_with_replacement
        comps = sorted({tuple(np.bincount(list(c), minlength=3))
                        for c in combinations_with_replacement(range(3), 6)})
        pmf = d.log_prob(torch.tensor(comps, dtype=torch.float32, device=d.probs.device)).exp()
        index = {c: i for i, c in enumerate(comps)}
        counts = np.zeros(len(comps), np.int64)
        for row in x.numpy():
            counts[index[tuple(int(v) for v in row)]] += 1
        pmf = pmf.double().cpu().numpy()
        return gof.multinomial_goodness_of_fit(pmf / pmf.sum(), counts)
    if not x.is_floating_point():
        hi = int(x.max()) + 1
        pmf = d.log_prob(torch.arange(hi, dtype=torch.float32, device=d.mean.device)).exp()
        pmf = pmf.double().cpu().numpy()
        pmf = np.append(pmf, max(1.0 - pmf.sum(), 0.0))
        return gof.lumped_goodness_of_fit(pmf, np.bincount(x.numpy(), minlength=hi + 1))
    if name == "SineBivariateVonMises":
        exact = dist.SineBivariateVonMises(*(torch.tensor(float(v), dtype=torch.float64) for v in (
            d.phi_loc, d.psi_loc, d.phi_concentration, d.psi_concentration)),
            correlation=torch.tensor(float(d.correlation), dtype=torch.float64))
        return gof.torus_goodness_of_fit(exact, x)
    probs = d.log_prob(x.to(d.mean.device)).exp().double().cpu()
    return gof.auto_goodness_of_fit(x.double(), probs)


def _raises(fn):
    try:
        fn()
    except NotImplementedError:
        return True
    return False


def _bessel_recurrence(max_order, kappa):
    """``log I_m(kappa)`` for m = 0 .. max_order by the upward recurrence
    ``I_{m+1} = I_{m-1} - (2m / kappa) I_m`` from ``i0e`` and ``i1e`` (in the
    exponentially scaled values; unstable once m passes kappa)."""
    prev, cur = torch.special.i0e(kappa), torch.special.i1e(kappa)
    out = [prev, cur]
    for m in range(1, max_order):
        prev, cur = cur, prev - (2.0 * m / kappa) * cur
        out.append(cur)
    return torch.log(torch.stack(out, -1).clamp(min=torch.finfo(kappa.dtype).tiny)) + \
        kappa.unsqueeze(-1)


def phase_new_families(device):
    """16c: the new families on CUDA tensors against CPU tensors, draws from a
    CUDA generator through the port's gof, one Gamma reparameterised
    gradient on the card against the CPU's, and the Bessel quadrature timed
    against the i0e/i1e recurrence; returns the wall seconds."""
    from numpyro_tpu_torch.distributions.directional import log_bessel_i_orders
    from numpyro_tpu_torch.distributions.util import _gamma_draw_derivative

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    q = torch.linspace(0.05, 0.95, 12).reshape(4, 3)
    worst, checked = 0.0, 0
    for name, params in NEW_FAMILIES.items():
        d_cpu, d_dev = new_family(name, params, cpu), new_family(name, params, device)
        x = d_cpu.sample(torch.Generator().manual_seed(164), (4,))
        for method, arg in (("log_prob", x), ("cdf", x), ("icdf", q)):
            try:
                want = getattr(d_cpu, method)(arg)
            except NotImplementedError:
                try:
                    getattr(d_dev, method)(arg.to(device))
                except NotImplementedError:
                    continue
                raise SystemExit(f"16c: {name}.{method} raises on the CPU only")
            got = getattr(d_dev, method)(arg.to(device))
            if got.device.type != device.type:
                raise SystemExit(f"16c: {name}.{method} came back on {got.device}")
            err = ((got.cpu() - want).abs() / (FAMILY_ATOL + FAMILY_RTOL * want.abs())).max()
            worst, checked = max(worst, err.item()), checked + 1
            if not err <= 1.0:
                raise SystemExit(f"16c: {name}.{method} on the card is off the CPU's: "
                                 f"{got.cpu().tolist()} against {want.tolist()}")
        draw = d_dev.sample(torch.Generator(device=device).manual_seed(165), (8,))
        if draw.device.type != device.type or not bool(d_dev.support(draw).all()):
            raise SystemExit(f"16c: {name}'s draws are off its support or its device")
    # ImproperUniform: a log density of 0 on the card, and no sampler there either
    flat = dist.ImproperUniform(dist.constraints.positive, (3,), ())
    if not (bool((flat.log_prob(torch.rand(4, 3, device=device)) == 0).all())
            and _raises(lambda: flat.sample(torch.Generator(device=device)))):
        raise SystemExit("16c: ImproperUniform's log_prob is not 0 or it draws on the card")
    pvalues = {}
    for label, (name, params) in GOF_CASES.items():
        d = new_family(name, params, device)
        x = d.sample(torch.Generator(device=device).manual_seed(166), (GOF_DRAWS,))
        if x.device.type != device.type or torch.isnan(x.double()).any():
            raise SystemExit(f"16c: {label}'s draws are not finite or off the device")
        pvalues[label] = _gof_of(name, d, x)
    low = min(pvalues, key=pvalues.get)
    # one reparameterised gradient of a Gamma draw on the card: the exact
    # derivative of the same draw on the CPU, through the series, the
    # continued fraction and (from a = 50) Temme's expansion
    alpha = torch.tensor([0.3, 2.0, 40.0, 5e3, 1e5], device=device, requires_grad=True)
    g = dist.Gamma(alpha, 1.0).sample(torch.Generator(device=device).manual_seed(167), (64,))
    g.sum().backward()
    want = _gamma_draw_derivative(alpha.detach().cpu().expand(64, 5),
                                  g.detach().cpu()).sum(0).float()
    grad_err = ((alpha.grad.cpu() - want).abs() / want.abs()).max().item()
    def timed(fn):
        # CUDA events on the card; the host's clock in a CPU rehearsal
        if device.type == "cuda":
            return cuda_ms(fn, reps=3)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    # the cost of the exact derivative on 4,096 draws, beside PyTorch's
    # rational approximation (not gated)
    shape4k = torch.rand(4096, device=device) * 50 + 0.1
    draws4k = torch._standard_gamma(shape4k)
    exact_ms = timed(lambda: _gamma_draw_derivative(shape4k, draws4k))
    rational_ms = timed(lambda: torch._standard_gamma_grad(shape4k, draws4k))
    # the Bessel quadrature against the recurrence, not gated
    kappa = torch.rand(4096, device=device) * 20 + 0.5
    quad_ms = timed(lambda: log_bessel_i_orders(49, kappa))
    rec_ms = timed(lambda: _bessel_recurrence(49, kappa))
    low_orders = (log_bessel_i_orders(49, kappa)[:, :4] - _bessel_recurrence(49, kappa)[:, :4])
    wall = time.perf_counter() - t0
    log(f"[discrete] 16c {len(NEW_FAMILIES)} classes, {checked} calls on the card within rtol "
        f"{FAMILY_RTOL}, atol {FAMILY_ATOL} of the CPU's (worst {worst:.3f} of the bound); "
        f"{GOF_DRAWS} draws each on a CUDA generator through gof: "
        + ", ".join(f"{k} p {v:.3f}" for k, v in pvalues.items())
        + f" (gate {GOF_FAILURE_RATE}); a Gamma draw's gradient on the card within "
        f"{grad_err:.2e} of the CPU's exact derivative; that derivative {exact_ms:.3f} ms on "
        f"4,096 draws (PyTorch's rational approximation {rational_ms:.3f} ms); Bessel values of orders 0-49 at 4,096 "
        f"concentrations: quadrature {quad_ms:.3f} ms, i0e/i1e recurrence {rec_ms:.3f} ms "
        f"(orders 0-3 apart by {low_orders.abs().max().item():.2e}, not gated); {wall:.2f} s")
    if not pvalues[low] > GOF_FAILURE_RATE:
        raise SystemExit(f"16c: {low}'s draws on the card fail the gof test (p "
                         f"{pvalues[low]:.2e})")
    if not grad_err < 1e-5:
        raise SystemExit(f"16c: the Gamma draw's gradient on the card is {grad_err:.2e} off the "
                         "CPU's")
    return wall


def phase_sixteen(device):
    """Phase 16: ucbadmit, the von Mises mixture and the new families;
    returns the walls of its legs, 16a's ms per evaluation and its
    Predictive's seconds (16c only on the card)."""
    launches0 = dict(glm.launch_counts)
    wall_a, ms_a, predictive_s = phase_ucbadmit(device)
    wall_b, ms_b = phase_ssbvm(device)
    walls = {"16a": wall_a, "16b": wall_b}
    if device.type == "cuda":
        walls["16c"] = phase_new_families(device)
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("16: the phase launched a GLM kernel")
    return walls, {"16a": ms_a, "16b": ms_b}, predictive_s


# phase 17, the structured and matrix families.  Its budget is 5 s on a host
# where phase 6's main leg takes 24.0 ms per evaluation.  (a) the LKJ prior
# of the Stan User's Guide ("Multivariate priors for hierarchical models"),
# as NumPyro's LKJCholesky docstring writes it: L ~ LKJCholesky(5, 2), 5
# scales ~ HalfNormal(2.5), 5 means ~ Normal(0, 5), LKJ_ROWS rows of
# MultivariateNormal(mu, scale_tril=sigma L); the data from numpy (seed 0)
# with LKJ_CORR, whose entries reach +-0.6, LKJ_SD and LKJ_MU.  Chains,
# warmup, samples and depths, cut to the budget in a CPU rehearsal
# (`python3 -m dev.phase17 cpu`) and on the card: at 32 chains and 20 + 10
# phase 17 took 6.8 s warm on an H100 80GB at 700 W (`dev.phase17 --sizing`),
# over its 5 s, at 15 + 5 for 17a and 10 + 5 for 17b about 4.5.  e, the
# largest of the 10 |posterior mean - generating correlation|, within
# LKJ_GATE of the JAX package's own e at this configuration, key 0, LKJ_REF:
# the gate max(2 e_J, e_J + 0.05); keys 1-4 read within 0.1044 of it
# (`JAX_PLATFORMS=cpu python3 -m dev.structured_reference lkj`)
LKJ_DIM, LKJ_ROWS, LKJ_ETA = 5, 500, 2.0
LKJ_CORR = ((1.0, 0.6, 0.3, 0.0, -0.2),
            (0.6, 1.0, 0.4, 0.1, -0.3),
            (0.3, 0.4, 1.0, -0.4, 0.0),
            (0.0, 0.1, -0.4, 1.0, 0.5),
            (-0.2, -0.3, 0.0, 0.5, 1.0))
LKJ_SD = (1.0, 2.0, 0.5, 1.5, 1.0)
LKJ_MU = (0.0, 1.0, -1.0, 0.5, 2.0)
LKJ_RUN = (32, 15, 5, (3, 3))
LKJ_REF = 0.2765
LKJ_GATE = 0.553
# (b) an ordered Gaussian mixture: mu ~ Normal(0, 5) through OrderedTransform,
# w ~ Dirichlet(1, 1, 1), s ~ HalfNormal(1), MIX_N points of
# MixtureSameFamily(Categorical(w), Normal(mu, s)) drawn from numpy (seed 0)
# with MIX_LOCS, MIX_WEIGHTS and MIX_SCALE.  No NUTS run: at 32 chains and
# 10 + 5 (1.4-2.1 s of the script on an H100 80GB at 700 W) neither
# package's chains left their starts (location error 1.44 in the port, 1.49
# in the JAX package, `dev.structured_reference mix`), and phase 17 ran
# over its 5 s with it, so 17b is the check below alone
MIX_N, MIX_LOCS, MIX_WEIGHTS, MIX_SCALE = 300, (-2.0, 0.0, 3.0), (0.3, 0.4, 0.3), 0.7
# and, since 17a's gate is wide at its length, each model's potential and
# its gradient at STRUCTURED_POINTS unconstrained points (numpy normals
# of scale 0.5, seed 174) on the card against the CPU's, at rtol
# STRUCTURED_RTOL (the gradient with an atol of STRUCTURED_RTOL times each
# site's largest component), as 16b's check.  At scale 1 some points give a
# badly conditioned LKJ factor, whose float32 solves on the card and the CPU
# read 6.6e-5 apart (`python3 -m dev.phase17` on an H100 80GB)
STRUCTURED_POINTS, STRUCTURED_RTOL = 256, 1e-4
# (c) the new classes and transforms on CUDA tensors against CPU tensors, at
# 15c's FAMILY_RTOL and FAMILY_ATOL; draws on a CUDA generator of
# STRUCTURED_GOF through the port's gof, on scalar statistics of known law
# (scipy), at GOF_FAILURE_RATE; CAR.log_prob at CAR_N sites timed
CAR_N = 100


def lkj_data(n=LKJ_ROWS):
    rng = np.random.default_rng(0)
    cov = np.outer(LKJ_SD, LKJ_SD) * np.array(LKJ_CORR)
    return rng.multivariate_normal(LKJ_MU, cov, size=n).astype(np.float32)


def lkj_model(y, observed=True):
    """The LKJ covariance model of phase 17a (``observed=False`` draws the
    rows, of ``y``'s shape)."""
    d = y.shape[-1]
    L = npt.sample("L", dist.LKJCholesky(d, torch.tensor(LKJ_ETA, device=y.device)))
    sigma = npt.sample("sigma", dist.HalfNormal(torch.full((d,), 2.5, device=y.device))
                       .to_event(1))
    mu = npt.sample("mu", dist.Normal(torch.zeros(d, device=y.device), 5.0).to_event(1))
    with npt.plate("obs", y.shape[0]):
        npt.sample("y", dist.MultivariateNormal(mu, scale_tril=sigma[..., None] * L),
                   obs=y if observed else None)


def mix_data(n=MIX_N):
    rng = np.random.default_rng(0)
    comp = rng.choice(3, size=n, p=MIX_WEIGHTS)
    return (np.array(MIX_LOCS)[comp] + MIX_SCALE * rng.normal(size=n)).astype(np.float32)


def mix_model(y, observed=True):
    """The ordered Gaussian mixture of phase 17b (``observed=False`` draws
    the points, of ``y``'s shape)."""
    from numpyro_tpu_torch.distributions.transforms import OrderedTransform

    zeros = torch.zeros(3, device=y.device)
    mu = npt.sample("mu", dist.TransformedDistribution(dist.Normal(zeros, 5.0),
                                                       OrderedTransform()))
    w = npt.sample("w", dist.Dirichlet(torch.ones(3, device=y.device)))
    s = npt.sample("s", dist.HalfNormal(torch.tensor(1.0, device=y.device)))
    with npt.plate("obs", y.shape[0]):
        npt.sample("y", dist.MixtureSameFamily(dist.Categorical(w), dist.Normal(mu, s)),
                   obs=y if observed else None)


def lkj_error(L):
    """The largest |posterior mean - generating correlation| below the
    diagonal, for draws ``L`` of the Cholesky factor."""
    corr = (L.double() @ L.double().transpose(-2, -1)).mean(0).cpu().numpy()
    rows, cols = np.tril_indices(L.shape[-1], -1)
    return float(np.abs(corr - np.array(LKJ_CORR))[rows, cols].max())


def count_syncs(fn):
    """``fn()``'s result and the host syncs it made on the card
    (``torch.cuda.set_sync_debug_mode("warn")``), as a dict from the
    ``file:line`` in the port that made each (the innermost frame of its
    stack in ``numpyro_tpu_torch``) to their count; empty on the CPU.  The
    notice that the mode is a prototype, given once a process, is no sync."""
    if not torch.cuda.is_available():
        return fn(), {}
    import traceback

    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1] if "numpyro_tpu_torch" in f.filename]
        where = frames[-1] if frames else traceback.extract_stack()[-2]
        site = f"{'/'.join(where.filename.split('/')[-2:])}:{where.lineno}"
        sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def potential_check(tag, model, y, points, rtol, seed, scale=1.0, device=None):
    """The potential of ``model`` on ``y`` (a tensor, or a tuple of the
    model's tensor arguments) and its gradient at ``points`` unconstrained
    points (numpy normals of ``scale``, ``seed``) on ``device`` (by default
    that of ``y``'s first tensor) against the CPU's, the gradient with an
    atol of ``rtol`` times each site's largest component.  Returns the worst
    relative error of the potential, the gradient's in units of its atol,
    the host syncs of the evaluation on that device (the second of two;
    ``count_syncs``) and the points mapped onto the sites' supports there."""
    out, rng = {}, np.random.default_rng(seed)
    args = y if isinstance(y, tuple) else (y,)
    for device in (device or args[0].device, torch.device("cpu")):
        info = infer_util.initialize_model(torch.Generator(device=device).manual_seed(seed),
                                           model, num_chains=points,
                                           model_args=tuple(a.to(device) for a in args))
        if not out:
            z = {k: rng.normal(0.0, scale, tuple(v.shape)).astype(np.float32)
                 for k, v in info.param_info.z.items()}
        step = infer_util.batched_value_and_grad(info.potential_fn)
        z_here = {k: torch.from_numpy(v).to(device) for k, v in z.items()}
        if not out:
            step(z_here)
            (pe, grad), sites = count_syncs(lambda: step(z_here))
            # one point at a time, as MCMC maps it over its draws
            constrained = torch.func.vmap(info.postprocess_fn)(z_here)
        else:
            pe, grad = step(z_here)
        out["cpu" if out else "here"] = (pe.double().cpu(),
                                         {k: g.double().cpu() for k, g in grad.items()})
    (pe_d, g_d), (pe_c, g_c) = out["here"], out["cpu"]
    pe_err = ((pe_d - pe_c).abs() / pe_c.abs()).max().item()
    g_err = max((((g_d[k] - g_c[k]).abs() - rtol * g_c[k].abs())
                 / (rtol * g_c[k].abs().max())).max().item() for k in g_c)
    if not (pe_err <= rtol and g_err <= 1.0 and set(g_d) == set(g_c)):
        raise SystemExit(f"{tag}: the potential or its gradient on the card is off the CPU's "
                         f"({pe_err:.2e}, {g_err:.3f} of the gradient's atol)")
    return pe_err, max(g_err, 0.0), sites, constrained


def _gate(tag, e, ref, gate, what):
    if not abs(e - ref) <= gate:
        raise SystemExit(f"{tag}: {what} {e:.4f} is off the JAX package's {ref} by more than "
                         f"{gate}")


def phase_lkj(device):
    """17a: NUTS on the LKJ covariance model; returns its wall seconds, ms
    per evaluation and host syncs per evaluation."""
    t0 = time.perf_counter()
    y = torch.from_numpy(lkj_data()).to(device)
    draws, stats, evals, ms = _mcmc_leg("17a", lkj_model, LKJ_RUN, 172, y)
    e = lkj_error(draws["L"])
    pe_err, g_err, sites, _ = potential_check("17a", lkj_model, y, STRUCTURED_POINTS,
                                              STRUCTURED_RTOL, 174, scale=0.5)
    syncs = sum(sites.values())
    wall = time.perf_counter() - t0
    chains, warmup, samples, depths = LKJ_RUN
    log(f"[structured] 17a LKJ covariance model ({LKJ_ROWS} rows, D {LKJ_DIM}), {chains} "
        f"chains, {warmup} + {samples}, depths {depths}: {evals} evaluations in "
        f"{stats['warmup_s'] + stats['sample_s']:.2f} s, {ms:.2f} ms per evaluation, {syncs} host "
        f"syncs per evaluation {sites}; e {e:.4f} (JAX {LKJ_REF}, gate {LKJ_GATE}); the potential "
        f"at {STRUCTURED_POINTS} points within {pe_err:.2e} of the CPU's, its gradient {g_err:.3f} "
        f"of its atol (rtol {STRUCTURED_RTOL}); {wall:.2f} s")
    _gate("17a", e, LKJ_REF, LKJ_GATE, "the largest correlation error")
    return wall, ms, syncs


def phase_ordered_mixture(device):
    """17b: the ordered mixture's potential and gradient at
    ``STRUCTURED_POINTS`` points on the card against the CPU's, and those
    points' locations increasing; returns its wall seconds and host syncs
    per evaluation."""
    t0 = time.perf_counter()
    y = torch.from_numpy(mix_data()).to(device)
    pe_err, g_err, sites, constrained = potential_check(
        "17b", mix_model, y, STRUCTURED_POINTS, STRUCTURED_RTOL, 174, scale=0.5)
    mu = constrained["mu"]
    if not (mu.device.type == device.type and bool((mu[..., 1:] > mu[..., :-1]).all())):
        raise SystemExit("17b: the ordered locations of a point are not increasing")
    syncs = sum(sites.values())
    wall = time.perf_counter() - t0
    log(f"[structured] 17b ordered mixture ({MIX_N} points, K 3): the potential at "
        f"{STRUCTURED_POINTS} points within {pe_err:.2e} of the CPU's, its gradient {g_err:.3f} "
        f"of its atol (rtol {STRUCTURED_RTOL}), their locations increasing; {syncs} host syncs "
        f"per evaluation {sites}; {wall:.2f} s")
    return wall, syncs


_RING4 = ((0.0, 1.0, 0.0, 1.0), (1.0, 0.0, 1.0, 0.0), (0.0, 1.0, 0.0, 1.0), (1.0, 0.0, 1.0, 0.0))
_COV2 = ((2.0, 0.5), (0.5, 1.0))
_CORR2 = ((1.0, 0.4), (0.4, 1.0))


def _ou_sde(x, t):
    return -x, 0.5


def structured_family(name, device):
    """A class of 17c on ``device``, at the parameters of the CPU tests
    (``tests/test_torch_structured*.py``, ``tests/test_torch_mixtures.py``)."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    cov3 = t(((4.0, 1.0, 0.5), (1.0, 3.0, -0.5), (0.5, -0.5, 2.0)))
    tril3 = t(np.linalg.cholesky(np.array(cov3.tolist())))
    if name == "MultivariateStudentT":
        return dist.MultivariateStudentT(t((4.0, 5.5, 9.0)), t(((0.0, 1.0, -1.0),) * 3), tril3)
    if name == "LKJCholesky":
        return dist.LKJCholesky(4, t((1.5, 3.0)))
    if name == "LKJ":
        return dist.LKJ(3, t(2.0))
    if name in ("Wishart", "WishartCholesky"):
        return getattr(dist, name)(t((7.0, 5.5)), scale_matrix=cov3)
    if name == "ZeroSumNormal":
        return dist.ZeroSumNormal(t(1.3), (3, 4))
    if name == "MatrixNormal":
        return dist.MatrixNormal(t(((0.5, -1.0), (0.0, 1.0), (2.0, 0.3))), tril3,
                                 t(((1.0, 0.0), (0.3, 0.8))))
    if name == "CAR":
        return dist.CAR(t((0.0, 0.5, -0.5, 1.0)), t((0.5, 0.8, -0.3)), t((2.0, 1.5, 0.7)),
                        t(_RING4))
    if name == "EulerMaruyama":
        return dist.EulerMaruyama(torch.linspace(0.0, 1.0, 6, device=device), _ou_sde,
                                  dist.Normal(t((0.0, 1.0)), 1.0))
    if name == "GaussianStateSpace":
        return dist.GaussianStateSpace(4, t(((0.9, 0.1), (0.0, 0.8))),
                                       covariance_matrix=t((_COV2, (((1.0, 0.0), (0.0, 0.5))))))
    if name == "CirculantNormal":
        return dist.CirculantNormal(t((0.0, 0.5, 0.0, -0.5, 1.0)),
                                    covariance_row=t((3.0, 1.0, 0.5, 0.5, 1.0)))
    if name == "FoldedDistribution":
        return dist.FoldedDistribution(dist.Normal(t((0.5, -1.0, 2.0)), t((1.0, 0.5, 2.0))))
    if name == "MixtureSameFamily":
        return dist.MixtureSameFamily(dist.Categorical(logits=t((-0.4, 0.4))),
                                      dist.Normal(t((-1.0, 1.0)), t((0.5, 1.5))))
    if name == "MixtureGeneral":
        return dist.MixtureGeneral(dist.Categorical(logits=t((0.3, -0.2))),
                                   [dist.Normal(t(-1.0), t(0.7)), dist.StudentT(t(4.0), t(1.0),
                                                                                t(1.0))])
    if name == "GaussianCopula":
        return dist.GaussianCopula(dist.Normal(t((0.5, -1.0)), t((1.0, 2.0))),
                                   correlation_matrix=t(_CORR2))
    if name == "GaussianCopulaBeta":
        return dist.GaussianCopulaBeta(t((2.0, 3.0)), t((3.0, 2.0)),
                                       correlation_matrix=t(((1.0, 0.7), (0.7, 1.0))))
    raise KeyError(name)


STRUCTURED = ("MultivariateStudentT", "LKJCholesky", "LKJ", "Wishart", "WishartCholesky",
              "ZeroSumNormal", "MatrixNormal", "CAR", "EulerMaruyama", "GaussianStateSpace",
              "CirculantNormal", "FoldedDistribution", "MixtureSameFamily", "MixtureGeneral",
              "GaussianCopula", "GaussianCopulaBeta")


def structured_transforms(device):
    """Each new transform of 17c on ``device`` with an input of its domain
    (numpy, seed 174)."""
    from numpyro_tpu_torch.distributions import transforms as T

    rng = np.random.default_rng(174)

    def t(v):
        return torch.tensor(np.asarray(v), dtype=torch.float32, device=device)

    a = rng.normal(size=(3, 3))
    spd = a @ a.T + 3 * np.eye(3)
    corr = spd / np.sqrt(np.outer(np.diag(spd), np.diag(spd)))
    simplex = np.exp(rng.normal(size=(2, 4)))
    return {
        "OrderedTransform": (T.OrderedTransform(), t(rng.normal(size=(2, 5)))),
        "SimplexToOrderedTransform": (T.SimplexToOrderedTransform(t(0.3)),
                                      t(simplex / simplex.sum(-1, keepdims=True))),
        "CorrCholeskyTransform": (T.CorrCholeskyTransform(), t(rng.normal(size=(2, 6)))),
        "CholeskyTransform": (T.CholeskyTransform(), t(spd)),
        "CorrMatrixCholeskyTransform": (T.CorrMatrixCholeskyTransform(), t(corr)),
        "SoftplusLowerCholeskyTransform": (T.SoftplusLowerCholeskyTransform(),
                                           t(rng.normal(size=(2, 6)))),
        "L1BallTransform": (T.L1BallTransform(), t(rng.normal(size=(2, 4)))),
        "ZeroSumTransform": (T.ZeroSumTransform(2), t(rng.normal(size=(2, 3, 4)))),
        "ComplexTransform": (T.ComplexTransform(), t(rng.normal(size=(3, 2)))),
        "RealFastFourierTransform": (T.RealFastFourierTransform((8,)),
                                     t(rng.normal(size=(2, 8)))),
        "PackRealFastFourierCoefficientsTransform": (
            T.PackRealFastFourierCoefficientsTransform((7,)), t(rng.normal(size=(2, 7)))),
        "RecursiveLinearTransform": (T.RecursiveLinearTransform(t(((0.5, 0.2), (-0.3, 0.8)))),
                                     t(rng.normal(size=(2, 13, 2)))),
    }


# the samplers whose draws on the card go through the port's gof (17c): the
# classes and parameters of tests/test_gof_extended.py (MatrixNormal's row
# factor as its lower triangle), CirculantNormal and MixtureSameFamily
STRUCTURED_GOF = ("MultivariateStudentT", "ZeroSumNormal", "LKJCholesky", "Wishart",
                  "MatrixNormal", "CirculantNormal", "MixtureSameFamily")


def gof_family(name, device):
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    if name == "MultivariateStudentT":
        return dist.MultivariateStudentT(t(8.0), t((0.0, 0.0)),
                                         t(np.linalg.cholesky(np.array(_COV2))))
    if name == "ZeroSumNormal":
        return dist.ZeroSumNormal(t(1.0), (4,))
    if name == "LKJCholesky":
        return dist.LKJCholesky(3, t(1.5))
    if name == "Wishart":
        return dist.Wishart(t(5.0), scale_matrix=torch.eye(2, device=device))
    if name == "MatrixNormal":
        return dist.MatrixNormal(torch.zeros(2, 2, device=device), t(((1.1, 0.0), (0.1, 1.1))),
                                 torch.eye(2, device=device))
    if name == "CirculantNormal":
        return dist.CirculantNormal(torch.zeros(5, device=device),
                                    covariance_row=t((3.0, 1.0, 0.5, 0.5, 1.0)))
    return structured_family("MixtureSameFamily", device)


def gof_statistics(name, d, x):
    """Scalar statistics of draws ``x`` of ``gof_family(name)`` with their
    exact densities (scipy, float64): a marginal and a joint one each."""
    import scipy.stats as st

    x = x.double().cpu()
    if name == "MultivariateStudentT":
        tril = d.scale_tril.double().cpu()
        white = torch.linalg.solve_triangular(tril, x[..., None], upper=False)[..., 0]
        q = white.square().sum(-1) / 2.0
        return {"x_1": (x[:, 0], st.t(8.0, 0.0, float(tril[0, 0])).pdf(x[:, 0].numpy())),
                "q / 2": (q, st.f(2, 8.0).pdf(q.numpy()))}
    if name == "ZeroSumNormal":
        sq = x.square().sum(-1)
        return {"x_1": (x[:, 0], st.norm(0.0, math.sqrt(0.75)).pdf(x[:, 0].numpy())),
                "|x|^2": (sq, st.chi2(3).pdf(sq.numpy()))}
    if name == "LKJCholesky":
        corr = x @ x.transpose(-2, -1)
        return {f"r_{i}{j}": (corr[:, i, j], 0.5 * st.beta(2.0, 2.0).pdf(
            0.5 * (corr[:, i, j].numpy() + 1))) for i, j in ((1, 0), (2, 1))}
    if name == "Wishart":
        trace = x.diagonal(dim1=-2, dim2=-1).sum(-1)
        return {"W_11": (x[:, 0, 0], st.chi2(5).pdf(x[:, 0, 0].numpy())),
                "trace": (trace, st.chi2(10).pdf(trace.numpy()))}
    if name == "MatrixNormal":
        row = d.scale_tril_row.double().cpu()
        sq = torch.linalg.solve_triangular(row, x, upper=False).square().sum((-2, -1))
        sd = float(torch.sqrt((row[1] ** 2).sum()))
        return {"X_21": (x[:, 1, 0], st.norm(0.0, sd).pdf(x[:, 1, 0].numpy())),
                "|R^-1 X|^2": (sq, st.chi2(4).pdf(sq.numpy()))}
    if name == "CirculantNormal":
        inv = torch.linalg.inv(d.covariance_matrix.double().cpu())
        q = ((x @ inv) * x).sum(-1)
        return {"x_1": (x[:, 0], st.norm(0.0, math.sqrt(3.0)).pdf(x[:, 0].numpy())),
                "x^T C^-1 x": (q, st.chi2(5).pdf(q.numpy()))}
    return {"x": (x, d.log_prob(x.float().to(d.mixing_distribution.logits.device)).exp()
                  .double().cpu().numpy())}


class RecordedDraws:
    """A draw source that takes its draws from a generator and keeps them,
    so that another device can replay them (``ReplayedDraws``)."""

    def __init__(self, gen):
        self.gen, self.items = gen, []

    def normals(self, shape, like):
        out = torch.randn(shape, generator=self.gen, device=self.gen.device, dtype=like.dtype)
        self.items.append(out)
        return out

    def gammas(self, alpha):
        out = torch._standard_gamma(alpha.detach(), generator=self.gen)
        self.items.append(out)
        return out


class ReplayedDraws:
    def __init__(self, items, device):
        self.items = [v.to(device) for v in items]

    def normals(self, shape, like):
        return self.items.pop(0)

    def gammas(self, alpha):
        return self.items.pop(0)


def _close_on(got, want):
    """The error of a result on the card against the CPU's, in units of
    ``FAMILY_ATOL + FAMILY_RTOL |want|``."""
    got, want = torch.view_as_real(got) if got.is_complex() else got, \
        torch.view_as_real(want) if want.is_complex() else want
    return ((got.cpu() - want).abs() / (FAMILY_ATOL + FAMILY_RTOL * want.abs())).max().item()


def wishart_gradient(device, gen, draws=64):
    """A reparameterised gradient of ``draws`` Wishart draws in the
    concentration and the scale factor on ``device``, drawing from ``gen``
    (a generator or a draw source)."""
    conc = torch.tensor([7.0, 5.5], device=device, requires_grad=True)
    tril = torch.tensor(((2.0, 0.0, 0.0), (0.5, 1.5, 0.0), (0.3, -0.4, 1.2)), device=device,
                        requires_grad=True)
    w = dist.Wishart(conc, scale_tril=tril).sample(gen, (draws,))
    (w * torch.linspace(0.5, 1.5, 9, device=device).reshape(3, 3)).sum().backward()
    return conc.grad, tril.grad


def phase_structured_families(device):
    """17c: the new classes and transforms on CUDA tensors against CPU
    tensors, draws on a CUDA generator through the port's gof, a Wishart
    reparameterised gradient on the card against the CPU's on the same
    draws, and CAR.log_prob and that gradient timed; returns the wall
    seconds."""
    from numpyro_tpu_torch.distributions.gof import auto_goodness_of_fit

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    worst, checked = 0.0, 0
    for name in STRUCTURED:
        d_cpu, d_dev = structured_family(name, cpu), structured_family(name, device)
        x = d_cpu.sample(torch.Generator().manual_seed(175), (4,))
        got = d_dev.log_prob(x.to(device))
        if got.device.type != device.type:
            raise SystemExit(f"17c: {name}.log_prob came back on {got.device}")
        err = _close_on(got, d_cpu.log_prob(x))
        worst, checked = max(worst, err), checked + 1
        if not err <= 1.0:
            raise SystemExit(f"17c: {name}.log_prob on the card is off the CPU's ({err:.2f} of "
                             "the bound)")
        draw = d_dev.sample(torch.Generator(device=device).manual_seed(176), (8,))
        if draw.device.type != device.type or not bool(torch.isfinite(d_dev.log_prob(draw)).all()):
            raise SystemExit(f"17c: {name}'s draws are off its device or its support")
    kl_q = {dev: structured_family("CirculantNormal", dev) for dev in (cpu, device)}
    kl = {dev: dist.kl_divergence(dist.Normal(torch.zeros(5, device=dev), 1.5).to_event(1), q)
          for dev, q in kl_q.items()}
    err = _close_on(kl[device], kl[cpu])
    worst, checked = max(worst, err), checked + 1
    if not err <= 1.0:
        raise SystemExit("17c: the KL of a Normal against a CirculantNormal on the card is off "
                         "the CPU's")
    on_dev = structured_transforms(device)
    for name, (tr_cpu, x_cpu) in structured_transforms(cpu).items():
        tr_dev, x_dev = on_dev[name]
        y_cpu, y_dev = tr_cpu(x_cpu), tr_dev(x_dev)
        for what, got, want in (("forward", y_dev, y_cpu),
                                ("inverse", tr_dev.inv(y_dev), tr_cpu.inv(y_cpu)),
                                ("log-det", tr_dev.log_abs_det_jacobian(x_dev, y_dev),
                                 tr_cpu.log_abs_det_jacobian(x_cpu, y_cpu))):
            if got.device.type != device.type:
                raise SystemExit(f"17c: {name} {what} came back on {got.device}")
            err = _close_on(got, want)
            worst, checked = max(worst, err), checked + 1
            if not err <= 1.0:
                raise SystemExit(f"17c: {name} {what} on the card is off the CPU's ({err:.2f} of "
                                 "the bound)")
    pvalues = {}
    for name in STRUCTURED_GOF:
        d = gof_family(name, device)
        x = d.sample(torch.Generator(device=device).manual_seed(177), (GOF_DRAWS // 4,))
        if x.device.type != device.type or not bool(torch.isfinite(x).all()):
            raise SystemExit(f"17c: {name}'s draws are not finite or off the device")
        for label, (stat, density) in gof_statistics(name, d, x).items():
            pvalues[f"{name} {label}"] = auto_goodness_of_fit(stat, density)
    low = min(pvalues, key=pvalues.get)
    # a reparameterised Wishart gradient on the card against the CPU's on the
    # same draws (chi-square draws through util.standard_gamma's exact
    # derivative, normals below the diagonal)
    recorded = RecordedDraws(torch.Generator(device=device).manual_seed(178))
    g_dev = wishart_gradient(device, recorded)
    g_cpu = wishart_gradient(cpu, ReplayedDraws(recorded.items, cpu))
    grad_err = max(_close_on(a, b) for a, b in zip(g_dev, g_cpu))

    def timed(fn):
        if device.type == "cuda":
            return cuda_ms(fn, reps=3)
        start = time.perf_counter()
        fn()
        return (time.perf_counter() - start) * 1e3

    # not gated: the Wishart gradient's cost on 4,096 draws beside its
    # forward (the gamma draw's exact derivative), and CAR.log_prob at
    # CAR_N sites with its host syncs
    gen = torch.Generator(device=device).manual_seed(179)
    conc = torch.tensor([7.0, 5.5], device=device)
    tril = structured_family("Wishart", device).scale_tril
    forward_ms = timed(lambda: dist.Wishart(conc, scale_tril=tril).sample(gen, (2048,)))
    grad_ms = timed(lambda: wishart_gradient(device, gen, 2048))
    ring = torch.zeros(CAR_N, CAR_N, device=device)
    idx = torch.arange(CAR_N, device=device)
    ring[idx, (idx + 1) % CAR_N] = 1.0
    ring[(idx + 1) % CAR_N, idx] = 1.0
    value = torch.randn(CAR_N, device=device)

    def car_log_prob():
        # a new instance: its first log_prob computes the spectrum
        return dist.CAR(torch.zeros(CAR_N, device=device), torch.tensor(0.5, device=device),
                        torch.tensor(2.0, device=device), ring).log_prob(value)

    car = dist.CAR(torch.zeros(CAR_N, device=device), torch.tensor(0.5, device=device),
                   torch.tensor(2.0, device=device), ring)
    car.log_prob(value)
    car_syncs = sum(count_syncs(car_log_prob)[1].values())
    again_syncs = sum(count_syncs(lambda: car.log_prob(value))[1].values())
    car_ms, again_ms = timed(car_log_prob), timed(lambda: car.log_prob(value))
    wall = time.perf_counter() - t0
    log(f"[structured] 17c {len(STRUCTURED)} classes, {len(on_dev)} "
        f"transforms and the KL row, {checked} results on the card within rtol {FAMILY_RTOL}, "
        f"atol {FAMILY_ATOL} of the CPU's (worst {worst:.3f} of the bound); {GOF_DRAWS // 4} draws "
        f"each on a CUDA generator through gof: " + ", ".join(
            f"{k} p {v:.3f}" for k, v in pvalues.items())
        + f" (gate {GOF_FAILURE_RATE}); a Wishart reparameterised gradient on the card within "
        f"{grad_err:.3f} of the bound of the CPU's on the same draws; 4,096 Wishart draws (2 x "
        f"2,048) {forward_ms:.3f} ms, with their gradient {grad_ms:.3f} ms; CAR.log_prob at "
        f"{CAR_N} sites on a new instance {car_ms:.3f} ms, {car_syncs} host syncs, again on "
        f"the same {again_ms:.3f} ms, {again_syncs} host syncs (not gated); {wall:.2f} s")
    if not pvalues[low] > GOF_FAILURE_RATE:
        raise SystemExit(f"17c: {low} of the draws on the card fails the gof test (p "
                         f"{pvalues[low]:.2e})")
    if not grad_err <= 1.0:
        raise SystemExit("17c: the Wishart gradient on the card is off the CPU's")
    return wall, {"forward_ms": forward_ms, "grad_ms": grad_ms, "car_ms": car_ms,
                  "car_syncs": car_syncs, "car_again_ms": again_ms, "car_again_syncs": again_syncs}


def phase_seventeen(device):
    """Phase 17: the LKJ covariance model, the ordered mixture's potential
    and the new families and transforms; returns the walls of its legs,
    17a's ms per evaluation, the host syncs per evaluation of 17a and 17b,
    and 17c's timings (17c only on the card)."""
    launches0 = dict(glm.launch_counts)
    wall_a, ms_a, syncs_a = phase_lkj(device)
    wall_b, syncs_b = phase_ordered_mixture(device)
    walls, extra = {"17a": wall_a, "17b": wall_b}, {}
    if device.type == "cuda":
        walls["17c"], extra = phase_structured_families(device)
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("17: the phase launched a GLM kernel")
    return walls, ms_a, {"17a": syncs_a, "17b": syncs_b}, extra

# phase 18, the model DSL's tail.  (a) ``examples/annotation.py`` at
# its widths: K classes, J annotators, N items, the data drawn as its main()
# draws them (numpy's RandomState(0)); NUTS with vectorized chains, warmup,
# samples and depths ANNOT_RUN, cut to phase 18's budget.  e, the largest
# |posterior mean of pi - the share of each class among the items' true
# classes|, within ANNOT_GATE of the JAX package's own e at this
# configuration, key 0, ANNOT_REF: the gate max(2 e_J, e_J + 0.05)
# (`JAX_PLATFORMS=cpu python3 -m dev.annotation_reference`; keys 1-4 read
# within 0.0095 of it).  Sized on the card: 114 evaluations, 1.83-1.88 s, and
# phase 18 2.1 s warm (`python3 -m dev.phase18 --sizing`, H100 80GB at
# 700 W).  The potential and gradient at ANNOT_POINTS unconstrained points
# (numpy normals of scale 0.5, seed 181) on the card against the CPU's at
# rtol ANNOT_RTOL, as 16b's
ANNOT_K, ANNOT_J, ANNOT_N = 3, 5, 60
ANNOT_RUN = (32, 10, 5, (3, 3))
ANNOT_REF = 0.0180
ANNOT_GATE = 0.068
ANNOT_POINTS, ANNOT_RTOL = 256, 1e-4
# (b) the DSL model on a DSL_G x DSL_N grid of numpy normals (seed 0) with
# DSL_MISSING of them missing; its potential and gradient at DSL_POINTS points
# (numpy normals, seed 183) on the card against the CPU's and against its
# twin at rtol DSL_RTOL.  Every constant is made on the data's device by
# ``new_full`` (a fill, no copy from the host)
DSL_G, DSL_N, DSL_MISSING = 3, 8, 6
DSL_POINTS, DSL_RTOL = 256, 1e-4


def annotation_data(n=ANNOT_N, k=ANNOT_K, j=ANNOT_J):
    """``examples/annotation.py``'s data: the items' true classes and the
    annotators' labels, ``(n,)`` and ``(n, j)``."""
    rng = np.random.RandomState(0)
    true_c = rng.randint(0, k, size=n)
    conf = 0.75 * np.eye(k) + 0.25 / k
    annotations = np.stack(
        [[rng.choice(k, p=conf[true_c[i]]) for _ in range(j)] for i in range(n)])
    return true_c, annotations


def dawid_skene(positions, annotations, num_classes, num_annotators):
    """``examples/annotation.py``'s model: per-annotator confusion matrices,
    each item's true class ``c`` enumerated out."""
    J = positions.shape[0]
    N = annotations.shape[0]
    device = annotations.device
    pi = npt.sample("pi", dist.Dirichlet(torch.ones(num_classes, device=device)))
    with npt.plate("annotator", num_annotators, dim=-2):
        with npt.plate("class", num_classes):
            beta = npt.sample("beta", dist.Dirichlet(
                torch.eye(num_classes, device=device) * 4 + torch.ones(num_classes, device=device)))
    with npt.plate("item", N, dim=-2):
        c = npt.sample("c", dist.Categorical(pi), infer={"enumerate": "parallel"})
        with npt.plate("position", J, dim=-1):
            npt.sample("y", dist.Categorical(Vindex(beta)[positions, c, :]), obs=annotations)


def annotation_model(annotations):
    """``dawid_skene`` as the example calls it: one slot per annotator."""
    positions = torch.arange(annotations.shape[1], device=annotations.device)
    dawid_skene(positions, annotations, ANNOT_K, annotations.shape[1])


def annotation_error(pi_draws, true_c):
    shares = np.bincount(true_c, minlength=ANNOT_K) / true_c.shape[0]
    return float(np.abs(pi_draws.double().mean(0).cpu().numpy() - shares).max())


def phase_annotation(device):
    """18a: the Dawid-Skene model's potential against the CPU's, then NUTS;
    returns its wall seconds, ms per evaluation and host syncs per
    evaluation."""
    t0 = time.perf_counter()
    true_c, annotations = annotation_data()
    y = torch.from_numpy(annotations).to(device)
    pe_err, g_err, sites, _ = potential_check("18a", annotation_model, y, ANNOT_POINTS,
                                              ANNOT_RTOL, 181, scale=0.5)
    draws, stats, evals, ms = _mcmc_leg("18a", annotation_model, ANNOT_RUN, 182, y)
    e = annotation_error(draws["pi"], true_c)
    syncs = sum(sites.values())
    wall = time.perf_counter() - t0
    chains, warmup, samples, depths = ANNOT_RUN
    log(f"[dsl] 18a annotation.py ({ANNOT_N} items, {ANNOT_J} annotators, {ANNOT_K} classes, c "
        f"enumerated through Vindex): the potential at {ANNOT_POINTS} points within "
        f"{pe_err:.2e} of the CPU's, its gradient {g_err:.3f} of its atol (rtol {ANNOT_RTOL}), "
        f"{syncs} host syncs per evaluation {sites}; NUTS {chains} chains, {warmup} + "
        f"{samples}, depths {depths}: {evals} evaluations in "
        f"{stats['warmup_s'] + stats['sample_s']:.2f} s, {ms:.2f} ms per evaluation; e {e:.4f} "
        f"(JAX {ANNOT_REF}, gate {ANNOT_GATE}); {wall:.2f} s")
    _gate("18a", e, ANNOT_REF, ANNOT_GATE, "the largest class-share error")
    return wall, ms, syncs


def dsl_data(g=DSL_G, n=DSL_N, missing=DSL_MISSING):
    """18b's grid: numpy normals about a row mean, ``missing`` of them NaN."""
    rng = np.random.default_rng(0)
    y = (rng.normal(size=(g, 1)) + 0.5 * rng.normal(size=(g, n))).astype(np.float32)
    y.reshape(-1)[rng.choice(g * n, missing, replace=False)] = np.nan
    return y


def dsl_model(y):
    """18b: ``scope``, ``collapse`` of a Normal mean whose likelihood's scale
    ``sigma`` is latent, ``cond`` on the latent ``u``, and a ``scale``-d grid
    under ``plate_stack`` observed where ``y`` is not NaN (``obs_mask``).
    ``cond`` stands outside ``scope``: a branch runs blocked from the
    handlers around it, so its sites would be looked up by their unscoped
    names (in the JAX package too)."""
    c = functools.partial(y.new_full, ())
    mask = ~torch.isnan(y)
    obs = torch.where(mask, y, c(0.0))
    with handlers.scope(prefix="dsl"):
        mu = npt.sample("mu", dist.Normal(c(0.0), c(2.0)).expand([y.shape[0]]).to_event(1))
        sigma = npt.sample("sigma", dist.HalfNormal(c(1.0)))
        with handlers.collapse():
            theta = npt.sample("theta", dist.Normal(c(0.5), c(2.0)))
            npt.sample("anchor", dist.Normal(theta, sigma), obs=c(1.3))
    u = npt.sample("u", dist.Normal(c(0.0), c(1.0)))
    shift = cond(u > 0, lambda s: npt.sample("shift", dist.Normal(s, c(1.0))),
                 lambda s: npt.sample("shift", dist.Normal(-s, c(2.0))), c(1.0))
    with handlers.scope(prefix="dsl"), handlers.scale(scale=0.5), \
            npt.plate_stack("grid", tuple(y.shape)):
        npt.sample("y", dist.Normal(mu[:, None] + shift, sigma), obs=obs, obs_mask=mask)


def dsl_twin(y):
    """``dsl_model`` written without those handlers: the scoped names, the
    compound marginal, the branches' parameters selected, the masked
    latent and the half-weighted observed term by hand."""
    c = functools.partial(y.new_full, ())
    mask = ~torch.isnan(y)
    obs = torch.where(mask, y, c(0.0))
    mu = npt.sample("dsl/mu", dist.Normal(c(0.0), c(2.0)).expand([y.shape[0]]).to_event(1))
    sigma = npt.sample("dsl/sigma", dist.HalfNormal(c(1.0)))
    npt.sample("dsl/anchor", dist.Normal(c(0.5), torch.sqrt(c(2.0).square() + sigma.square())),
               obs=c(1.3))
    u = npt.sample("u", dist.Normal(c(0.0), c(1.0)))
    up = u > 0
    shift = npt.sample("shift", dist.Normal(torch.where(up, c(1.0), -c(1.0)),
                                                torch.where(up, c(1.0), c(2.0))))
    with npt.plate("dsl/grid_0", y.shape[0], dim=-2), npt.plate("dsl/grid_1", y.shape[1], dim=-1):
        fn = dist.Normal(mu[:, None] + shift, sigma)
        latent = npt.sample("dsl/y_unobserved", fn.mask(False))
        npt.factor("dsl/y_observed", 0.5 * fn.log_prob(torch.where(mask, obs, latent)))


def phase_dsl(device):
    """18b: the DSL model's potential on the card against the CPU's and its
    twin's, and the host syncs of an evaluation with validation off and on;
    returns its wall seconds and those sync counts."""
    t0 = time.perf_counter()
    y = torch.from_numpy(dsl_data()).to(device)
    pe_err, g_err, sites_off, _ = potential_check("18b", dsl_model, y, DSL_POINTS, DSL_RTOL, 183)
    gen = torch.Generator(device=device)
    steps = {}
    for name, model in (("model", dsl_model), ("twin", dsl_twin)):
        info = infer_util.initialize_model(gen.manual_seed(183), model, num_chains=DSL_POINTS,
                                           model_args=(y,))
        shapes = {k: tuple(v.shape) for k, v in info.param_info.z.items()}
        steps[name] = (shapes, infer_util.batched_value_and_grad(info.potential_fn))
    shapes = steps["model"][0]
    if steps["twin"][0] != shapes:
        raise SystemExit(f"18b: the twin's latents {steps['twin'][0]} are not the model's "
                         f"{shapes}")
    rng = np.random.default_rng(184)
    z = {k: torch.from_numpy(rng.normal(size=shapes[k]).astype(np.float32)).to(device)
         for k in sorted(shapes)}
    out, syncs = {}, {}
    for label, name, validate in (("off", "model", False), ("twin", "twin", False),
                                  ("on", "model", True)):
        with dist.validation_enabled(validate):
            steps[name][1](z)
            out[label], sites = count_syncs(lambda: steps[name][1](z))
        syncs[label] = sum(sites.values())
    pe, grad = out["off"]
    twin_err = ((out["twin"][0] - pe).abs() / pe.abs()).max().item()
    twin_g = max(((out["twin"][1][k] - grad[k]).abs().max() / grad[k].abs().max()).item()
                 for k in grad)
    same_on = bool((out["on"][0] == pe).all()) and all(
        bool((out["on"][1][k] == grad[k]).all()) for k in grad)
    wall = time.perf_counter() - t0
    log(f"[dsl] 18b obs_mask, collapse, cond, scale, scope and plate_stack ({DSL_G} x {DSL_N} "
        f"grid, {DSL_MISSING} missing): the potential at {DSL_POINTS} points within {pe_err:.2e} "
        f"of the CPU's, its gradient {g_err:.3f} of its atol (rtol {DSL_RTOL}); the twin's "
        f"within {twin_err:.2e}, its gradient {twin_g:.2e} of the largest entry; host syncs per "
        f"evaluation: validation off {syncs['off']} (twin {syncs['twin']}), on {syncs['on']}, "
        f"the same values on: {same_on}; {wall:.2f} s")
    if not (twin_err <= DSL_RTOL and twin_g <= DSL_RTOL and same_on):
        raise SystemExit("18b: the potential differs from its twin's, or with validation on")
    if syncs["off"] > syncs["twin"]:
        raise SystemExit(f"18b: the handlers add host syncs: {syncs['off']} against the twin's "
                         f"{syncs['twin']}")
    return wall, syncs


def phase_eighteen(device):
    """Phase 18: the Dawid-Skene model and the DSL model; returns the walls of
    its legs, 18a's ms per evaluation and the host syncs per evaluation."""
    launches0 = dict(glm.launch_counts)
    wall_a, ms_a, syncs_a = phase_annotation(device)
    wall_b, syncs_b = phase_dsl(device)
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("18: the phase launched a GLM kernel")
    return {"18a": wall_a, "18b": wall_b}, ms_a, {"18a": syncs_a, **syncs_b}


# phase 19, the inference tail. Its budget is 4 s on the reference host of
# PERF.md section 2 (the ECS leg at 24.0 ms an evaluation). (a)
# initialize_model at INIT_CHAINS chains on the covtype model in split mode at
# full size under the five strategies of INIT_STRATEGIES (the values of
# init_to_value: numpy normals of scale 0.5, seed 190): each potential and
# gradient at the found params against the plain version within check_kernel's
# tolerances; init_to_feasible and init_to_mean give zeros and init_to_value
# its values, exactly; the per-coordinate spread over chains of init_to_median
# within 4 Monte-Carlo errors of the spread of the median of MEDIAN_OF standard
# normals (init_to_sample's: of one standard normal). A strategy that draws
# traces the model once per chain, a kernel launch each
# (infer.util._batched_candidates). Then NUTS from init_to_median, INIT_RUN
# (chains, warmup, samples, depths; chains cut from 256 to 64 before its first
# run on the card: 64 more traces, not 256), transfer_states_to_host and the
# cross-chain diagnostics on the card against the CPU's at CROSS_RTOL. Expected
# before its first run on an H100: 2-4 ms a model trace (a CPU rehearsal,
# `python3 -m dev.phase19 cpu`: 1.4 ms of host time beside the plain
# likelihood), so 0.5-1.0 s for each of the two drawing strategies, 0.1-0.3 s
# for the rest of (a)'s inits and checks, 0.2 s for NUTS's init and 0.9-1.2 s
# for its ~170 evaluations; (b) 0.2-0.5 s. Phase 19: 2.4-4.2 s, about 1.9-3.4 s
# on the reference host. Measured on an H100 80GB at 700 W in the whole script:
# 1.5 s (0.39 ms a trace). (b) get_dependencies, get_model_relations and
# generate_graph_specification of the covtype model (one glm_split launch for
# the trace and one under provenance, each) and of phase 18b's DSL model,
# against INSPECT_REF, the JAX package's on the CPU (`JAX_PLATFORMS=cpu python3
# -m dev.inspect_reference`); compute_log_probs of the DSL model at batch_ndims
# 0 and 1 on the card against the CPU's at LOG_PROBS_RTOL.
INIT_CHAINS = 256
INIT_STRATEGIES = {"init_to_median": init_to_median, "init_to_mean": init_to_mean,
                   "init_to_feasible": init_to_feasible, "init_to_sample": init_to_sample,
                   "init_to_value": None}
MEDIAN_OF = 15
INIT_RUN = (64, 10, 10, (3, 3))
CROSS_RTOL = 1e-5
LOG_PROBS_RTOL = 1e-5
INSPECT_REF = {'covtype': {'dependencies': {'prior_dependencies': {'w': {'w': set()},
                                                                   'lik': {'lik': set(),
                                                                           'w': set()}},
                                            'posterior_dependencies': {'w': {'w': set(),
                                                                             'lik': set()}}},
                           'relations': {'sample_sample': {'w': [], 'lik': ['w']},
                                         'sample_param': {'w': [], 'lik': []},
                                         'sample_dist': {'w': 'Normal', 'lik': 'Unit'},
                                         'param_constraint': {},
                                         'plate_sample': {},
                                         'observed': ['lik']},
                           'graph': ({None: ['w', 'lik']},
                                     {},
                                     {'w': (False, 'Normal', ''), 'lik': (True, 'Unit', '')},
                                     [('w', 'lik')])},
               'dsl': {'dependencies': {'prior_dependencies': {'dsl/mu': {'dsl/mu': set()},
                                                               'dsl/sigma': {'dsl/sigma': set()},
                                                               'dsl/anchor': {'dsl/anchor': set(),
                                                                              'dsl/sigma': set()},
                                                               'u': {'u': set()},
                                                               'shift': {'shift': set(),
                                                                         'u': set()},
                                                               'dsl/y_unobserved': {'dsl/y_unobserved': set()},
                                                               'dsl/y_observed': {'dsl/y_observed': set(),
                                                                                  'dsl/mu': set(),
                                                                                  'dsl/sigma': set(),
                                                                                  'shift': set(),
                                                                                  'dsl/y_unobserved': set()}},
                                        'posterior_dependencies': {'dsl/mu': {'dsl/mu': set(),
                                                                              'dsl/y_observed': set(),
                                                                              'dsl/sigma': set(),
                                                                              'shift': set(),
                                                                              'dsl/y_unobserved': set()},
                                                                   'dsl/sigma': {'dsl/sigma': set(),
                                                                                 'dsl/anchor': set(),
                                                                                 'dsl/y_observed': set(),
                                                                                 'shift': set(),
                                                                                 'dsl/y_unobserved': set()},
                                                                   'u': {'u': set(),
                                                                         'shift': set()},
                                                                   'shift': {'shift': set(),
                                                                             'dsl/y_observed': set(),
                                                                             'dsl/y_unobserved': set()},
                                                                   'dsl/y_unobserved': {'dsl/y_unobserved': set(),
                                                                                        'dsl/y_observed': set()}}},
                       'relations': {'sample_sample': {'dsl/mu': [],
                                                       'dsl/sigma': [],
                                                       'dsl/anchor': ['dsl/sigma'],
                                                       'u': [],
                                                       'shift': ['u'],
                                                       'dsl/y_unobserved': [],
                                                       'dsl/y_observed': ['dsl/mu',
                                                                          'dsl/sigma',
                                                                          'shift'],
                                                       'dsl/y': ['dsl/y_unobserved']},
                                     'sample_param': {'dsl/mu': [],
                                                      'dsl/sigma': [],
                                                      'dsl/anchor': [],
                                                      'u': [],
                                                      'shift': [],
                                                      'dsl/y_unobserved': [],
                                                      'dsl/y_observed': [],
                                                      'dsl/y': []},
                                     'sample_dist': {'dsl/mu': 'Normal',
                                                     'dsl/sigma': 'HalfNormal',
                                                     'dsl/anchor': 'Normal',
                                                     'u': 'Normal',
                                                     'shift': 'Normal',
                                                     'dsl/y_unobserved': 'Normal',
                                                     'dsl/y_observed': 'Normal',
                                                     'dsl/y': 'Deterministic'},
                                     'param_constraint': {},
                                     'plate_sample': {'dsl/grid_1': ['dsl/y_unobserved',
                                                                     'dsl/y_observed',
                                                                     'dsl/y'],
                                                      'dsl/grid_0': ['dsl/y_unobserved',
                                                                     'dsl/y_observed',
                                                                     'dsl/y']},
                                     'observed': ['dsl/anchor', 'dsl/y_observed']},
                       'graph': ({'dsl/grid_1': ['dsl/y_unobserved', 'dsl/y_observed', 'dsl/y'],
                                  'dsl/grid_0': ['dsl/y_unobserved', 'dsl/y_observed', 'dsl/y'],
                                  None: ['dsl/mu', 'dsl/sigma', 'dsl/anchor', 'u', 'shift']},
                                 {'dsl/grid_1': None, 'dsl/grid_0': 'dsl/grid_1'},
                                 {'dsl/mu': (False, 'Normal', ''),
                                  'dsl/sigma': (False, 'HalfNormal', ''),
                                  'dsl/anchor': (True, 'Normal', ''),
                                  'u': (False, 'Normal', ''),
                                  'shift': (False, 'Normal', ''),
                                  'dsl/y_unobserved': (False, 'Normal', ''),
                                  'dsl/y_observed': (True, 'Normal', ''),
                                  'dsl/y': (False, 'Deterministic', '')},
                                 [('dsl/sigma', 'dsl/anchor'),
                                  ('u', 'shift'),
                                  ('dsl/mu', 'dsl/y_observed'),
                                  ('dsl/sigma', 'dsl/y_observed'),
                                  ('shift', 'dsl/y_observed'),
                                  ('dsl/y_unobserved', 'dsl/y')])}}


def median_of_normals_moments(n=MEDIAN_OF):
    """The variance and fourth central moment of the median of ``n`` (odd)
    standard normals, by quadrature of its order-statistic density."""
    x = np.linspace(-8.0, 8.0, 32001)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))
    k = (n - 1) // 2
    coef = math.factorial(n) / (math.factorial(k) ** 2)
    density = coef * (cdf * (1.0 - cdf)) ** k * np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
    dx = x[1] - x[0]
    return float((x**2 * density).sum() * dx), float((x**4 * density).sum() * dx)


def spread_gap(draws, var, mu4):
    """The largest gap over coordinates between the standard deviation over
    chains of ``draws`` ``(C, D)`` and ``sqrt(var)``, in units of the
    Monte-Carlo error of a sample variance (``mu4``, the fourth moment)."""
    c = draws.shape[0]
    sd = draws.double().std(0).cpu().numpy()
    se = math.sqrt((mu4 - var**2 * (c - 3) / (c - 1)) / c) / (2 * math.sqrt(var))
    return float(np.abs(sd - math.sqrt(var)).max() / se)


def phase_init_strategies(X, y):
    """19a: the init strategies at INIT_CHAINS chains on the covtype model,
    then NUTS from init_to_median, the transfer of its states and the
    cross-chain diagnostics; returns the seconds, the glm_split launches and
    the seconds of one init_to_median try."""
    t0 = time.perf_counter()
    device = X.device
    data = glm.prepare_glm_data(X, y, dtype="split")
    values = torch.from_numpy(
        np.random.default_rng(190).normal(0.0, 0.5, D).astype(np.float32)).to(device)
    strategies = dict(INIT_STRATEGIES, init_to_value=init_to_value(values={"w": values}))
    plain_step = infer_util.batched_value_and_grad(functools.partial(
        infer_util.potential_energy, model, (data,), {"loglik": glm.plain_bernoulli_logits_loglik}))
    _, _, atol = glm.kernel_tolerances("split", N)
    launches, try_s = 0, None
    for name, strategy in strategies.items():
        before = glm.launch_counts["glm_split"]
        traces0, evals0 = infer_util.init_traces, infer_util.potential_evals
        t1 = time.perf_counter()
        info = infer_util.initialize_model(torch.Generator(device=device).manual_seed(191), model,
                                           num_chains=INIT_CHAINS, init_strategy=strategy,
                                           model_args=(data,))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        traces = infer_util.init_traces - traces0
        evals = infer_util.potential_evals - evals0
        n_launch = glm.launch_counts["glm_split"] - before
        launches += n_launch
        z = info.param_info.z["w"]
        pe, grad = info.param_info.potential_energy, info.param_info.z_grad["w"]
        pe_p, grad_p = plain_step({"w": z})
        pe_err = ((pe - pe_p).abs() / pe_p.abs()).max().item()
        g_need = ((grad - grad_p["w"]).abs() - G_RTOL * grad_p["w"].abs()).max().item()
        if name in ("init_to_median", "init_to_sample"):
            var, mu4 = median_of_normals_moments(MEDIAN_OF if name == "init_to_median" else 1)
            gap = spread_gap(z, var, mu4)
            held, reading = gap < 4, f"spread {gap:.2f} Monte-Carlo errors off the exact one"
        else:
            want = values if name == "init_to_value" else torch.zeros_like(values)
            held = bool((z == want).all())
            reading = f"exact values: {held}"
        if name == "init_to_median":
            try_s = secs
        log(f"[tail] 19a {name}, {INIT_CHAINS} chains: {secs:.3f} s, {traces} model traces, "
            f"{evals} batched evaluation(s), glm_split launches {n_launch}; the potential "
            f"{pe_err:.2e} off the plain version's (rtol {LL_RTOL}), the gradient's least "
            f"passing atol {g_need:.3e} (rtol {G_RTOL}, atol {atol:.3e}); {reading}")
        if n_launch != traces + evals:
            raise SystemExit(f"19a {name}: {n_launch} glm_split launches for {traces} traces and "
                             f"{evals} evaluations")
        if not (pe_err <= LL_RTOL and g_need <= atol and bool(torch.isfinite(pe).all())):
            raise SystemExit(f"19a {name}: the potential at the found params disagrees with the "
                             "plain version")
        if not held:
            raise SystemExit(f"19a {name}: the found params are not the strategy's")
    chains, warmup, samples, depths = INIT_RUN
    mcmc = MCMC(NUTS(model, init_strategy=init_to_median, max_tree_depth=depths),
                num_warmup=warmup, num_samples=samples, num_chains=chains)
    before = glm.launch_counts["glm_split"]
    mcmc.run(torch.Generator(device=device).manual_seed(192), data)
    stats = mcmc.last_run_stats
    n_launch = glm.launch_counts["glm_split"] - before
    launches += n_launch
    on_card = mcmc.get_samples(group_by_chain=True)["w"]
    r_hat, ess = cross_chain_diagnostics(on_card)
    pooled = pooled_step_size(mcmc.last_state.adapt_state).item()
    mcmc.transfer_states_to_host()
    on_host = mcmc.get_samples(group_by_chain=True)["w"]
    same = on_host.device.type == "cpu" and torch.equal(on_card.cpu(), on_host)
    r_err = ((r_hat.cpu() - split_gelman_rubin(on_host)).abs()
             / split_gelman_rubin(on_host).abs()).max().item()
    e_err = ((ess.cpu() - effective_sample_size(on_host)).abs()
             / effective_sample_size(on_host).abs()).max().item()
    log(f"[tail] 19a NUTS from init_to_median, {chains} chains, {warmup} + {samples}, depths "
        f"{depths}: {stats['potential_evals']} evaluations + {stats['init_traces']} init traces, "
        f"glm_split launches {n_launch}, init {stats['init_s']:.2f} s, warmup "
        f"{stats['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} s; transferred draws equal "
        f"bit for bit: {same}; R-hat (median {r_hat.median().item():.3f}) and ESS (median "
        f"{ess.median().item():.1f}) on the card within {r_err:.2e} and {e_err:.2e} of the CPU's "
        f"(rtol {CROSS_RTOL}); pooled step size {pooled:.4f}")
    if n_launch != stats["potential_evals"] + stats["init_traces"]:
        raise SystemExit(f"19a NUTS: {n_launch} glm_split launches for {stats['potential_evals']} "
                         f"evaluations and {stats['init_traces']} init traces")
    if not (same and r_err <= CROSS_RTOL and e_err <= CROSS_RTOL):
        raise SystemExit("19a: the transferred draws or the cross-chain diagnostics disagree")
    del data
    return time.perf_counter() - t0, launches, try_s


def graph_fields(spec):
    return (spec.membership, spec.parent,
            {k: (n.observed, n.dist_name, n.constraint) for k, n in spec.nodes.items()},
            spec.edges)


def phase_inspect(X, y):
    """19b: inspection of the covtype and DSL models on the card against the
    JAX package's literals, and compute_log_probs against the CPU's; returns
    the seconds and the glm_split launches."""
    t0 = time.perf_counter()
    device = X.device
    data = glm.prepare_glm_data(X, y, dtype="split")
    dsl_y = torch.from_numpy(dsl_data()).to(device)
    launches = 0
    for name, fn, args in (("covtype", model, (data,)), ("dsl", dsl_model, (dsl_y,))):
        before = dict(glm.launch_counts)
        relations = get_model_relations(fn, args)
        got = {"dependencies": get_dependencies(fn, args), "relations": relations,
               "graph": graph_fields(generate_graph_specification(relations))}
        n_launch = glm.launch_counts["glm_split"] - before["glm_split"]
        plain = glm.launch_counts["plain"] - before["plain"]
        launches += n_launch
        wrong = [k for k in got if got[k] != INSPECT_REF[name][k]]
        log(f"[tail] 19b {name}: dependencies, relations and graph equal the JAX package's: "
            f"{not wrong}; glm_split launches {n_launch}, plain {plain}; posterior dependencies "
            f"{got['dependencies']['posterior_dependencies']}")
        if wrong:
            raise SystemExit(f"19b {name}: {wrong} differ from the JAX package's: {got}")
        if name == "covtype" and (n_launch != 4 or plain != 0):
            raise SystemExit(f"19b: {n_launch} glm_split launches (4 expected: a trace and a "
                             f"provenance pass each for two calls), {plain} plain")
    cpu = torch.device("cpu")
    tr = handlers.trace(handlers.substitute(handlers.seed(dsl_model, 193),
                                            substitute_fn=init_to_sample())).get_trace(
        dsl_y.cpu())
    params = {k: v["value"] for k, v in tr.items()
              if v["type"] == "sample" and not v["is_observed"]}
    worst = 0.0
    for batch_ndims in (0, 1):
        lp = {}
        for where in (device, cpu):
            lp[where.type], _ = infer_util.compute_log_probs(
                dsl_model, (dsl_y.to(where),), {}, {k: v.to(where) for k, v in params.items()},
                batch_ndims=batch_ndims)
        for k, v in lp["cpu"].items():
            got = lp[device.type][k].cpu()
            if got.shape != v.shape:
                raise SystemExit(f"19b compute_log_probs: {k} has shape {tuple(got.shape)} on the "
                                 f"card and {tuple(v.shape)} on the CPU")
            worst = max(worst, ((got - v).abs() / v.abs().clamp(min=1e-30)).max().item())
    log(f"[tail] 19b compute_log_probs of the DSL model ({len(lp['cpu'])} sites) at batch_ndims 0 "
        f"and 1: within {worst:.2e} of the CPU's (rtol {LOG_PROBS_RTOL})")
    if not worst <= LOG_PROBS_RTOL:
        raise SystemExit("19b: compute_log_probs on the card disagrees with the CPU's")
    return time.perf_counter() - t0, launches


def phase_nineteen(X, y):
    """Phase 19: the init strategies, NUTS from init_to_median, the transfer
    and the cross-chain diagnostics, then inspection; returns the walls of
    its legs, the glm_split launches of each and the seconds of one
    init_to_median try at INIT_CHAINS chains."""
    wall_a, launches_a, try_s = phase_init_strategies(X, y)
    wall_b, launches_b = phase_inspect(X, y)
    return {"19a": wall_a, "19b": wall_b}, {"19a": launches_a, "19b": launches_b}, try_s


# phase 20, contrib: the HSGP approximation, the nested sampler and DCC/SDVI.
# Its budget is 8 s on the reference host of PERF.md section 2 (the ECS leg at
# 24.0 ms an evaluation). (a) examples/hsgp_example.py's model at its widths
# (HSGP_N points, m = HSGP_M, ell = HSGP_ELL, the example's data from numpy's
# RandomState(0)): its potential and gradient at HSGP_POINTS points (numpy
# normals of scale 0.5, seed 201) on the card against the CPU's at HSGP_RTOL
# with the host syncs of an evaluation, then NUTS (HSGP_RUN: chains, warmup,
# samples, depths), the posterior means of length and noise within 4 combined
# Monte-Carlo errors of the JAX package's run at the same configuration
# (HSGP_REF, `JAX_PLATFORMS=cpu python3 -m dev.contrib_reference hsgp`). (b)
# the Matérn (nu 1.5, 2.5) and periodic fragments in the same model, their
# potentials at HSGP_POINTS points on the card against the CPU's, and the
# periodic density at length PERIODIC_SHORT on the card, finite and within
# PERIODIC_RTOL of scipy's float64 ive. (c) the nested sampler on the conjugate
# model of tests/contrib/test_nested_sampling.py (NS_Y, NS_CONJ_RUN), log Z
# within 3 log_Z_err + 0.05 of the analytic one, and on
# examples/gaussian_shells.py's two shells (radius 2, width 0.1, prior
# [-6, 6]^2; SHELLS_RUN cut to the budget, SHELLS_DRAWS draws) under the
# example's own two asserts, which the JAX package's run at SHELLS_RUN passes
# too (`python3 -m dev.contrib_reference shells`). (d) DCC (DCC_RUN: chains,
# warmup, samples and NUTS depths a straight-line program) and SDVI (SDVI_RUN: Adam's step,
# steps, ELBO particles of the combination) on the two-branch model of
# tests/contrib/test_stochastic_support.py: the weights sum to 1 within 1e-4
# and each branch's within SS_GATE of its exact share (the JAX test's gate on
# the first), with the host syncs of an evaluation of a branch's model.
# Sized on an H100 80GB at 700 W (`python3 -m dev.phase20 --sizing`, warm):
# 20a 292 evaluations at 12.46 ms, 20c 337 and 407 batched evaluations at 3.02
# and 1.98 ms, 20d 230 evaluations; phase 20 7.6 s alone, 8.7 and 9.5 s in two
# whole runs (20a's first evaluations in the script cost 1.6-1.8 s more than
# alone), so 20a's sampling depth went from 3 to 2. Cut from the examples' and
# tests' lengths to that: 20a from one chain of 400 + 400 (from init_to_median,
# whose start the JAX run shares; at 20 warmup draws the chains had not met);
# 20c from 200 and 500 live points (one slice pass; at 40 live points the
# shells' left share fell outside the assert for one of eight JAX keys, at 80
# for none of ten); 20d from 300 + 300 and 500 steps at Adam(0.01): over 16
# seeds on the CPU each branch's weight came within 0.043 (DCC) and 0.041
# (SDVI) of the exact one at DCC_RUN and SDVI_RUN, where 16 chains of 12 + 6
# and 60 steps at Adam(0.15) missed the gate for two seeds in twelve each (the
# estimate of log Z averages over the posterior draws; more chains cost no
# more host time).
HSGP_N, HSGP_M, HSGP_ELL = 80, 20, 1.5
HSGP_RUN = (32, 30, 10, (3, 2))
HSGP_REF = {"length": {"mean": 0.401, "se_mean": 0.0209},
            "noise": {"mean": 0.1997, "se_mean": 0.0033}}
HSGP_POINTS, HSGP_RTOL = 256, 1e-4
PERIODIC_M, PERIODIC_W0 = 8, math.pi
PERIODIC_SHORT, PERIODIC_RTOL = 0.05, 1e-4
NS_Y = (0.7, 1.1, 0.9, 1.3, 0.8, 1.0, 1.2, 0.95, 1.05, 0.85)
NS_SP, NS_SO = 2.0, 0.5
NS_CONJ_RUN = {"num_live_points": 30, "num_delete": 10, "num_slices": 1, "max_samples": 4000}
SHELLS_RUN = {"num_live_points": 80, "num_delete": 24, "num_slices": 1, "max_samples": 4000}
SHELLS_CENTERS, SHELLS_RADIUS, SHELLS_WIDTH = ((-3.5, 0.0), (3.5, 0.0)), 2.0, 0.1
SHELLS_DRAWS = 2000
DCC_RUN = (64, 10, 5, (3, 3))
DCC_SLP_SAMPLES = 25
SDVI_RUN = (0.1, 80, 200)
SS_OBS, SS_GATE, SS_POINTS = 0.2, 0.1, 32


def hsgp_data(n=HSGP_N):
    """``examples/hsgp_example.py``'s data: ``x`` on [-1, 1] and ``sin(3x)``
    plus noise of 0.2 from numpy's RandomState(0), float32."""
    rng = np.random.RandomState(0)
    x = np.linspace(-1, 1, n).astype(np.float32)
    y = (np.sin(3 * x) + 0.2 * rng.randn(n)).astype(np.float32)
    return x, y


def hsgp_model(x, y=None, ell=HSGP_ELL, m=HSGP_M):
    """``examples/hsgp_example.py``'s model."""
    amp = npt.sample("amp", dist.HalfNormal(1.0))
    length = npt.sample("length", dist.LogNormal(-1.0, 1.0))
    noise = npt.sample("noise", dist.HalfNormal(0.5))
    f = hsgp_squared_exponential(x, alpha=amp, length=length, ell=ell, m=m)
    with npt.plate("N", x.shape[0]):
        npt.sample("y", dist.Normal(f, noise), obs=y)


def _fragment_model(fragment):
    """The example's model with ``fragment(x, amp, length)`` for its GP."""

    def model(x, y=None):
        amp = npt.sample("amp", dist.HalfNormal(1.0))
        length = npt.sample("length", dist.LogNormal(-1.0, 1.0))
        noise = npt.sample("noise", dist.HalfNormal(0.5))
        f = fragment(x, amp, length)
        with npt.plate("N", x.shape[0]):
            npt.sample("y", dist.Normal(f, noise), obs=y)

    return model


FRAGMENTS = {
    "matern 1.5": _fragment_model(lambda x, a, l: hsgp_matern(
        x, nu=1.5, alpha=a, length=l, ell=HSGP_ELL, m=HSGP_M)),
    "matern 2.5": _fragment_model(lambda x, a, l: hsgp_matern(
        x, nu=2.5, alpha=a, length=l, ell=HSGP_ELL, m=HSGP_M)),
    "periodic": _fragment_model(lambda x, a, l: hsgp_periodic_non_centered(
        x, alpha=a, length=l, w0=PERIODIC_W0, m=PERIODIC_M)),
}


def conjugate_model(y):
    """``tests/contrib/test_nested_sampling.py``'s conjugate model; its
    likelihood's scale is filled on the data's device (as a Python number it
    would be copied to the card at every evaluation, ROADMAP.md Queue 3)."""
    mu = npt.sample("mu", dist.Normal(0.0, NS_SP))
    with npt.plate("N", y.shape[0]):
        npt.sample("y", dist.Normal(mu, y.new_full((), NS_SO)), obs=y)


def conjugate_log_evidence(y=NS_Y):
    y = np.asarray(y)
    n = len(y)
    cov = NS_SO**2 * np.eye(n) + NS_SP**2 * np.ones((n, n))
    _, logdet = np.linalg.slogdet(2 * np.pi * cov)
    return float(-0.5 * (logdet + y @ np.linalg.solve(cov, y)))


def shell_logpdf(x, loc, radius, width):
    """``examples/gaussian_shells.py``: a ring of ``radius`` and thickness
    ``width`` about ``loc``."""
    r = torch.linalg.norm(x - loc, dim=-1)
    return -0.5 * ((r - radius) / width) ** 2 - math.log(math.sqrt(2 * math.pi) * width)


def shells_model(center1, center2, radius, width):
    """``examples/gaussian_shells.py``'s model."""
    x = npt.sample("x", dist.Uniform(-6.0, 6.0).expand([2]).to_event(1))
    lik = torch.logaddexp(shell_logpdf(x, center1, radius, width),
                          shell_logpdf(x, center2, radius, width))
    npt.factor("shells", lik)


def shells_checks(samples, centers=SHELLS_CENTERS, radius=SHELLS_RADIUS, width=SHELLS_WIDTH):
    """The example's two asserts on ``(n, 2)`` numpy draws: the share of
    draws in the left shell and the median distance to the nearest ring,
    with whether each holds."""
    left = float((samples[:, 0] < 0).mean())
    to_ring = np.minimum(
        np.abs(np.linalg.norm(samples - np.asarray(centers[0]), axis=-1) - radius),
        np.abs(np.linalg.norm(samples - np.asarray(centers[1]), axis=-1) - radius))
    median = float(np.median(to_ring))
    return left, median, 0.2 < left < 0.8, median < 3 * width


def branch_model():
    """``tests/contrib/test_stochastic_support.py``'s two-branch model."""
    m = npt.sample("m", dist.Bernoulli(0.5), infer={"branching": True})
    if m == 0:
        mean = npt.sample("a1", dist.Normal(0.0, 1.0))
    else:
        mean = npt.sample("a2", dist.Normal(1.0, 1.0))
    npt.sample("obs", dist.Normal(mean, 1.0), obs=SS_OBS)


def branch_weights():
    """The exact weight of each branch: N(obs | 0, 2) and N(obs | 1, 2)
    normalized, by the branch value."""
    z = [math.exp(-0.5 * (SS_OBS - mu) ** 2 / 2.0) for mu in (0.0, 1.0)]
    return {"0": z[0] / sum(z), "1": z[1] / sum(z)}


def phase_hsgp(device):
    """20a: the HSGP example's potential against the CPU's, then NUTS;
    returns its wall seconds, ms per evaluation and host syncs per
    evaluation."""
    t0 = time.perf_counter()
    x, y = (torch.from_numpy(a).to(device) for a in hsgp_data())
    pe_err, g_err, sites, _ = potential_check("20a", hsgp_model, (x, y), HSGP_POINTS,
                                              HSGP_RTOL, 201, scale=0.5)
    check_s = time.perf_counter() - t0
    chains, warmup, samples, depths = HSGP_RUN
    mcmc = MCMC(NUTS(hsgp_model, init_strategy=init_to_median, max_tree_depth=depths),
                num_warmup=warmup,
                num_samples=samples, num_chains=chains, device=device)
    mcmc.run(202, x, y)
    stats = mcmc.last_run_stats
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    ms = (stats["warmup_s"] + stats["sample_s"]) / evals * 1e3
    z = mcmc.get_samples(group_by_chain=True)
    if not all(torch.isfinite(v).all() for v in z.values()):
        raise SystemExit("20a: draws that are not finite")
    worst, readings = 0.0, []
    for site in ("length", "noise"):
        got, ref = mc_moments(z[site].cpu()), HSGP_REF[site]
        ratio = abs(got["mean"] - ref["mean"]) / (4 * math.hypot(got["se_mean"], ref["se_mean"]))
        worst = max(worst, ratio)
        readings.append(f"{site} {got['mean']:.4f} +- {got['se_mean']:.4f} (JAX "
                        f"{ref['mean']:.4f} +- {ref['se_mean']:.4f})")
    syncs = sum(sites.values())
    wall = time.perf_counter() - t0
    log(f"[contrib] 20a hsgp_example.py ({HSGP_N} points, m {HSGP_M}, ell {HSGP_ELL}): the "
        f"potential at {HSGP_POINTS} points within {pe_err:.2e} of the CPU's, its gradient "
        f"{g_err:.3f} of its atol (rtol {HSGP_RTOL}), {syncs} host syncs per evaluation {sites}, "
        f"{check_s:.2f} s; NUTS {chains} chains, {warmup} + {samples}, depths {depths}: init "
        f"{stats['init_s']:.2f} s, {evals} evaluations in "
        f"{stats['warmup_s'] + stats['sample_s']:.2f} s, {ms:.2f} ms per evaluation; "
        f"{'; '.join(readings)}; largest gap / 4 combined errors {worst:.3f}; {wall:.2f} s")
    if not worst < 1.0:
        raise SystemExit("20a: the posterior means of length or noise are off the JAX package's "
                         "by more than 4 combined Monte-Carlo errors")
    return wall, ms, syncs


def phase_hsgp_fragments(device):
    """20b: the Matérn and periodic fragments' potentials against the CPU's
    and the periodic density at a short length; returns its wall seconds
    and the host syncs per evaluation of each fragment."""
    import scipy.special

    t0 = time.perf_counter()
    x, y = (torch.from_numpy(a).to(device) for a in hsgp_data())
    syncs = {}
    for k, (name, model) in enumerate(FRAGMENTS.items()):
        pe_err, g_err, sites, _ = potential_check(f"20b {name}", model, (x, y), HSGP_POINTS,
                                                  HSGP_RTOL, 210 + k, scale=0.5)
        syncs[name] = sum(sites.values())
        log(f"[contrib] 20b {name}: the potential at {HSGP_POINTS} points within {pe_err:.2e} "
            f"of the CPU's, its gradient {g_err:.3f} of its atol, {syncs[name]} host syncs per "
            f"evaluation {sites}")
    short = x.new_full((), PERIODIC_SHORT)
    q2 = diag_spectral_density_periodic(1.0, short, PERIODIC_M).double().cpu().numpy()
    a = PERIODIC_SHORT ** -2
    exact = np.array([(1.0 if j == 0 else 2.0) * scipy.special.ive(j, a)
                      for j in range(PERIODIC_M)])
    err = float(np.abs(q2 / exact - 1).max())
    log(f"[contrib] 20b the periodic density at length {PERIODIC_SHORT} on the card: "
        f"{np.round(q2, 5).tolist()}, within {err:.2e} of scipy's float64 ive (rtol "
        f"{PERIODIC_RTOL})")
    if not (np.isfinite(q2).all() and err <= PERIODIC_RTOL):
        raise SystemExit("20b: the periodic density at a short length is not finite or is off")
    return time.perf_counter() - t0, syncs


def _nested_run(tag, model, run, seed, device, *args):
    """One NestedSampler run; returns it, its seconds and its stats line."""
    ns = NestedSampler(model, constructor_kwargs=run, device=device)
    t0 = time.perf_counter()
    _, sites = count_syncs(lambda: ns.run(seed, *args))
    res = ns.diagnostics()
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = ns.last_run_stats
    line = (f"{st['iterations']} iterations, {st['evaluations']} batched evaluations "
            f"({st['evaluations'] / max(st['iterations'], 1):.1f} an iteration), "
            f"{secs / st['evaluations'] * 1e3:.2f} ms an evaluation, {secs:.2f} s, host syncs "
            f"{sum(sites.values())} ({sum(sites.values()) / max(st['iterations'], 1):.2f} an "
            f"iteration; {sites}); log Z {float(res.log_Z):.4f} +- {float(res.log_Z_err):.4f}, "
            f"ESS {float(res.ess):.1f}")
    if not (math.isfinite(float(res.log_Z)) and res.samples.device.type == device.type):
        raise SystemExit(f"{tag}: log Z is not finite or the samples are off the device")
    return ns, secs, line


def phase_nested(device):
    """20c: the nested sampler on the conjugate model and on the two shells;
    returns its wall seconds and the ms per batched evaluation of each."""
    t0 = time.perf_counter()
    y = torch.tensor(NS_Y, device=device)
    ns, secs_c, line = _nested_run("20c", conjugate_model, NS_CONJ_RUN, 203, device, y)
    res = ns.diagnostics()
    truth = conjugate_log_evidence()
    gap, bound = abs(float(res.log_Z) - truth), 3 * float(res.log_Z_err) + 0.05
    log(f"[contrib] 20c conjugate model, {NS_CONJ_RUN}: {line}; analytic {truth:.4f}, gap "
        f"{gap:.4f} (gate {bound:.4f})")
    if not gap <= bound:
        raise SystemExit("20c: the conjugate model's log Z is off the analytic one")
    ms = {"conjugate": secs_c / ns.last_run_stats["evaluations"] * 1e3}
    centers = [torch.tensor(c, device=device) for c in SHELLS_CENTERS]
    ns, secs_s, line = _nested_run("20c", shells_model, SHELLS_RUN, 204, device, *centers,
                                   SHELLS_RADIUS, SHELLS_WIDTH)
    samples = ns.get_samples(205, SHELLS_DRAWS)["x"]
    if samples.shape != (SHELLS_DRAWS, 2) or samples.device.type != device.type:
        raise SystemExit(f"20c: shells draws {tuple(samples.shape)} on {samples.device}")
    left, median, left_ok, ring_ok = shells_checks(samples.cpu().numpy())
    log(f"[contrib] 20c gaussian_shells.py, {SHELLS_RUN}: {line}; {SHELLS_DRAWS} draws, "
        f"{left:.2%} in the left shell (0.2 to 0.8), median distance to the nearest ring "
        f"{median:.4f} (below {3 * SHELLS_WIDTH})")
    if not (left_ok and ring_ok):
        raise SystemExit("20c: the shells' draws fail the example's asserts")
    ms["shells"] = secs_s / ns.last_run_stats["evaluations"] * 1e3
    return time.perf_counter() - t0, ms


def _branch_gates(tag, weights):
    """The weights' sum and each branch's weight against the exact one."""
    exact = branch_weights()
    total = sum(float(v) for v in weights.values())
    first = next(iter(weights))
    gaps = {k: abs(float(v) - exact[k]) for k, v in weights.items()}
    first_gap = abs(float(weights[first]) - exact["0"])
    log(f"[contrib] 20d {tag}: weights {({k: round(float(v), 4) for k, v in weights.items()})}, "
        f"exact {({k: round(v, 4) for k, v in exact.items()})}, sum {total:.6f}; the first "
        f"branch found {first!r}, its weight {first_gap:.4f} off z0 / (z0 + z1) (the JAX test's "
        f"gate {SS_GATE}); each branch off its own by at most {max(gaps.values()):.4f}")
    if not (abs(total - 1) < 1e-4 and set(weights) == {"0", "1"} and first_gap < SS_GATE
            and max(gaps.values()) < SS_GATE):
        raise SystemExit(f"20d {tag}: the branch weights are off the exact ones")


def phase_stochastic_support(device):
    """20d: DCC and SDVI on the two-branch model; returns the walls of each
    and the host syncs per evaluation of a branch's model."""
    t0 = time.perf_counter()
    slp = handlers.condition(branch_model, data={"m": 0})
    tr = handlers.trace(handlers.seed(slp, torch.Generator(device=device).manual_seed(0))
                        ).get_trace()
    if not isinstance(tr["m"]["value"], int):
        raise SystemExit(f"20d: the conditioned branch value is a {type(tr['m']['value'])}")
    pe_err, g_err, sites, _ = potential_check("20d", slp, (), SS_POINTS, HSGP_RTOL, 206,
                                              device=device)
    syncs = sum(sites.values())
    chains, warmup, samples, depths = DCC_RUN
    dcc = DCC(branch_model, mcmc_kwargs=dict(num_warmup=warmup, num_samples=samples,
                                             num_chains=chains, device=device),
              kernel_cls=functools.partial(NUTS, max_tree_depth=depths),
              num_slp_samples=DCC_SLP_SAMPLES)
    t1, evals0 = time.perf_counter(), infer_util.potential_evals
    res = dcc.run(207)
    evals = infer_util.potential_evals - evals0
    wall_dcc = time.perf_counter() - t0
    log(f"[contrib] 20d DCC, {DCC_SLP_SAMPLES} simulations, NUTS {chains} chains, {warmup} + "
        f"{samples} at depths {depths} a branch: {time.perf_counter() - t1:.2f} s, {evals} "
        f"batched evaluations; the branch m = 0's potential at {SS_POINTS} points within "
        f"{pe_err:.2e} of the CPU's, {syncs} host syncs per evaluation {sites}")
    _branch_gates("DCC", res.slp_weights)
    t1 = time.perf_counter()
    lr, steps, particles = SDVI_RUN
    sdvi = SDVI(branch_model, Adam(lr), svi_num_steps=steps, num_slp_samples=DCC_SLP_SAMPLES,
                combine_elbo_particles=particles, device=device)
    res = sdvi.run(208)
    wall_sdvi = time.perf_counter() - t1
    log(f"[contrib] 20d SDVI, Adam({lr}), {steps} steps a branch, {particles} particles: "
        f"{wall_sdvi:.2f} s")
    _branch_gates("SDVI", res.slp_weights)
    return {"20d DCC": wall_dcc, "20d SDVI": wall_sdvi}, syncs


def phase_twenty(device):
    """Phase 20: HSGP, the nested sampler and DCC/SDVI; returns the walls of
    its legs, 20a's ms per evaluation, the nested runs' ms per evaluation and
    the host syncs per evaluation."""
    launches0 = dict(glm.launch_counts)
    wall_a, ms_a, syncs_a = phase_hsgp(device)
    wall_b, syncs_b = phase_hsgp_fragments(device)
    wall_c, ms_c = phase_nested(device)
    walls_d, syncs_d = phase_stochastic_support(device)
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("20: the phase launched a GLM kernel")
    return ({"20a": wall_a, "20b": wall_b, "20c": wall_c, **walls_d}, ms_a, ms_c,
            {"20a": syncs_a, **syncs_b, "20d": syncs_d})


# phase 21, contrib part two: SteinVI, SVGD and ASVGD.  (a) SVGD on covtype at
# full width, the SVGD paper's experiment (Liu & Wang 2016, sec. 5: 100
# particles, AdaGrad): particles, steps, Adagrad step size.  Every step is one
# batched evaluation of the model for all particles, one glm_split launch at
# B = 100; the init traces the model STEIN_INIT_TRACES times (AutoDelta's
# prototype and init_to_median's trace and potential, SteinVI's trace of the
# model).  The gate is the bench's 0.05, which the JAX package's own run at
# this configuration meets (`JAX_PLATFORMS=cpu python3 -m dev.stein_reference
# covtype 100 100 0.5 0 1`: 0.0079 and 0.0084).  Adagrad(0.5) settles by about
# 75 steps at a tenth of the rows on the CPU, where 0.1 and 0.2 had not settled
# by 200.
STEIN_COVTYPE = (100, 100, 0.5)
STEIN_COVTYPE_GATE = 0.05
STEIN_INIT_TRACES = 4
# (b) examples/stein_bnn.py at its widths (60 points, hidden 8, 8 particles, 2
# ELBO draws, AutoNormal, Adagrad(0.5), RBFKernel()): steps (cut from the
# example's 500 to the phase's budget) and predictive draws of y.  The gate on
# the RMSE of the predictive mean against 0.5 sin(4x) is max(2e, e + 0.05) for
# e = 0.2983, the JAX package's own run at this length (`JAX_PLATFORMS=cpu
# python3 -m dev.stein_reference bnn`: 0.2983-0.3414 over keys 0-4).
STEIN_BNN_N, STEIN_BNN_HIDDEN, STEIN_BNN_PARTICLES = 60, 8, 8
STEIN_BNN = (80, 200)
STEIN_BNN_GATE = 0.5967
# (c) ASVGD on the Gaussian of tests/contrib/test_einstein.py: particles,
# cycles, steps; the SVGD forces of the kernels and one SteinVI step under
# ProbabilityProductKernel: particles; on the card against the CPU from the
# same particles (and draws), rtol STEIN_RTOL
ASVGD_RUN = (50, 3, 60)
STEIN_FORCE_PARTICLES, STEIN_STEP_PARTICLES = 20, 6
STEIN_RTOL = 1e-4


class TableDraws:
    """A draw source of the einstein module (``contrib.einstein.steinvi``):
    ``normals`` serves ``tables`` in order, each indexed by the (batched)
    indices that ``at`` collected (particle, ELBO draw), and ``randints``
    serves ``ints``; ``generator`` takes the init traces' draws."""

    def __init__(self, tables, ints=(), index=(), generator=None):
        self.tables, self.ints, self.index = list(tables), list(ints), index
        self.generator = generator if generator is not None else torch.Generator()
        self._next = 0

    def at(self, i):
        return TableDraws(self.tables, self.ints, self.index + (i,), self.generator)

    def normals(self, shape, like):
        if self._next >= len(self.tables):
            raise RuntimeError("the draw source has no table left")
        out = self.tables[self._next]
        self._next += 1
        for i in self.index:
            # a batched 0-dim index under vmap selects through index_select
            out = out[i] if isinstance(i, int) else out.index_select(0, i.reshape(1))[0]
        if tuple(out.shape) != tuple(shape):
            raise RuntimeError(f"a draw of shape {tuple(shape)} met a table of {tuple(out.shape)}")
        return out

    def randints(self, low, high, shape):
        return self.ints.pop(0)


def stein_bnn_data(n=STEIN_BNN_N):
    """``examples/stein_bnn.py``'s data: ``x`` on [-1, 1] and ``0.5 sin(4x)``
    plus noise of 0.1 from numpy's RandomState(0), float32."""
    rng = np.random.RandomState(0)
    x = np.linspace(-1, 1, n)[:, None]
    y = 0.5 * np.sin(4 * x[:, 0]) + 0.1 * rng.randn(n)
    return x.astype(np.float32), y.astype(np.float32)


def stein_bnn_model(x, y=None, hidden=STEIN_BNN_HIDDEN):
    """``examples/stein_bnn.py``'s network; its Python-number scales are
    copied to the card at every evaluation (ROADMAP Queue 3)."""
    D = x.shape[1]
    w1 = npt.sample("w1", dist.Normal(torch.zeros((D, hidden), device=x.device), 1.0).to_event(2))
    b1 = npt.sample("b1", dist.Normal(torch.zeros(hidden, device=x.device), 1.0).to_event(1))
    w2 = npt.sample("w2", dist.Normal(torch.zeros(hidden, device=x.device), 1.0).to_event(1))
    prec = npt.sample("prec", dist.Gamma(1.0, 0.1))
    mean = torch.tanh(x @ w1 + b1) @ w2
    with npt.plate("N", x.shape[0]):
        npt.sample("y", dist.Normal(mean, 1 / torch.sqrt(prec)), obs=y)


def stein_gauss(loc, scale):
    """The Gaussian of ``tests/contrib/test_einstein.py``."""
    npt.sample("x", dist.Normal(loc, scale).to_event(1))


def stein_two(loc, scale):
    """Two sites, so that the graphical kernel has two blocks."""
    a = npt.sample("a", dist.Normal(loc, scale).to_event(1))
    npt.sample("b", dist.Normal(0.5 * a.sum(), scale[0]))


def stein_args(device):
    return (torch.tensor([1.0, -1.0], device=device), torch.tensor([1.0, 0.5], device=device))


def _close(tag, got, want, rtol=STEIN_RTOL):
    """The largest error of ``got`` (a tensor or a dict of them, on the card)
    against ``want`` (the CPU's) in units of ``rtol`` times each entry's
    largest component; raises above 1."""
    got = got if isinstance(got, dict) else {"": got}
    want = want if isinstance(want, dict) else {"": want}
    worst = 0.0
    for k in want:
        a, b = got[k].double().cpu(), want[k].double()
        scale = rtol * max(b.abs().max().item(), 1e-30)
        worst = max(worst, ((a - b).abs() / (rtol * b.abs() + scale)).max().item())
    if not worst <= 1.0:
        raise SystemExit(f"21c {tag}: the card is off the CPU by {worst:.3f} of the tolerance")
    return worst


def phase_svgd_covtype(X, y, true_w, posterior, kernels):
    """21a: SVGD on covtype in split mode at full width; returns its wall
    seconds, ms per step (init included), host syncs of a step and
    glm_split launches.  On CPU tensors (a rehearsal) the plain version's
    calls are counted in their place and the kernel is not timed."""
    particles, steps, step_size = STEIN_COVTYPE
    on_card = X.device.type == "cuda"
    name = "glm_split" if on_card else "plain"
    data = glm.prepare_glm_data(X, y, dtype="split")
    svgd = SVGD(model, Adagrad(step_size), RBFKernel(), num_stein_particles=particles)
    glm.reset_launch_counts()
    t0 = time.perf_counter()
    res = svgd.run(210, steps, data)
    losses = res.losses.cpu()
    wall = time.perf_counter() - t0
    launches = dict(glm.launch_counts)
    (state, _), sites = count_syncs(lambda: svgd.update(res.state, data))
    w = svgd.get_params(state)["auto_w_loc"]
    step_launches = glm.launch_counts[name] - launches[name]
    if (launches[name] != STEIN_INIT_TRACES + steps or step_launches != 1
            or any(v for k, v in glm.launch_counts.items() if k != name)):
        raise SystemExit(f"21a: launched {launches} in the run and {dict(glm.launch_counts)} with "
                         f"one more step; expected {STEIN_INIT_TRACES} + {steps} {name} "
                         "launches, then one")
    if not torch.isfinite(losses).all():
        raise SystemExit("21a: a loss is not finite")
    err = (w.mean(0).cpu() - torch.from_numpy(true_w)).abs().max().item()
    std = w.double().std(0).cpu()
    ratio = std / posterior["std"].cpu()
    syncs = sum(sites.values())
    ms = wall / steps * 1e3
    log(f"[stein] 21a SVGD on covtype, {particles} particles, {steps} steps of "
        f"Adagrad({step_size}): {wall:.2f} s, {ms:.2f} ms per step (init included); loss "
        f"{losses[0].item():.1f} -> {losses[-1].item():.1f}; max |particle mean - true_w| "
        f"{err:.4f} (gate {STEIN_COVTYPE_GATE}); per-coefficient std of the particles median "
        f"{std.median().item():.5f} (NUTS's in phase 4: {posterior['std'].median().item():.5f}; "
        f"ratio median {ratio.median().item():.3f}, min {ratio.min().item():.3f}, max "
        f"{ratio.max().item():.3f}); {syncs} host syncs in a step {sites}; {name} launches "
        f"{launches[name] + 1} ({STEIN_INIT_TRACES} init traces, one a step)")
    if not err < STEIN_COVTYPE_GATE:
        raise SystemExit(f"21a: the particles' mean is off by {err:.4f} (>= {STEIN_COVTYPE_GATE})")
    if on_card:
        # the kernel at this batch, by CUDA events, beside its bound
        d_pad, n_pad = data.x_t.shape
        wb = w.contiguous()
        t = cuda_ms(lambda: glm.glm_value_and_grad(wb, data))
        bound, by = bound_ms("split", particles, d_pad, n_pad)
        log(f"[stein] glm_split at {particles} chains: {t:.3f} ms (bound {bound:.4f} ms by {by}, "
            f"share {bound / t:.3f})")
        kernels["glm_split"][f"ms_at_{particles}_chains"] = t
        kernels["glm_split"][f"bound_ms_at_{particles}_chains"] = bound
    return wall, ms, syncs, launches[name] + 1


def phase_stein_bnn(device):
    """21b: examples/stein_bnn.py's SteinVI and its mixture predictive;
    returns its wall seconds, ms per step (init included) and host syncs of
    a step."""
    steps, draws = STEIN_BNN
    x, y = (torch.from_numpy(a).to(device) for a in stein_bnn_data())
    guide = autoguide.AutoNormal(stein_bnn_model)
    stein = SteinVI(stein_bnn_model, guide, Adagrad(0.5), RBFKernel(),
                    num_stein_particles=STEIN_BNN_PARTICLES, num_elbo_particles=2)
    t0 = time.perf_counter()
    res = stein.run(211, steps, x, y)
    losses = res.losses.cpu()
    wall_run = time.perf_counter() - t0
    _, sites = count_syncs(lambda: stein.update(res.state, x, y))
    pred = MixtureGuidePredictive(stein_bnn_model, guide, res.params, set(res.params),
                                  num_samples=draws)(212, x)
    mean = pred["y"].mean(0).double().cpu()
    wall = time.perf_counter() - t0
    truth = 0.5 * torch.sin(4 * x[:, 0].double().cpu())
    rmse = (mean - truth).pow(2).mean().sqrt().item()
    syncs = sum(sites.values())
    ms = wall_run / steps * 1e3
    log(f"[stein] 21b stein_bnn.py, {STEIN_BNN_PARTICLES} particles, 2 ELBO draws, {steps} "
        f"steps: {wall_run:.2f} s, {ms:.2f} ms per step (init included); loss "
        f"{losses[0].item():.1f} -> {losses[-1].item():.1f}; {syncs} host syncs in a step "
        f"{sites}; MixtureGuidePredictive {draws} draws of y {tuple(pred['y'].shape)}, "
        f"assignments {tuple(pred['mixture_assignments'].shape)}: the predictive mean's RMSE "
        f"against 0.5 sin(4x) {rmse:.4f} (gate {STEIN_BNN_GATE})")
    if not torch.isfinite(losses).all():
        raise SystemExit("21b: a loss is not finite")
    if pred["y"].shape != (draws, STEIN_BNN_N) or pred["y"].device.type != device.type:
        raise SystemExit(f"21b: predictive draws {tuple(pred['y'].shape)} on {pred['y'].device}")
    if STEIN_BNN_GATE is not None and not rmse <= STEIN_BNN_GATE:
        raise SystemExit(f"21b: the predictive mean's RMSE {rmse:.4f} is above {STEIN_BNN_GATE}")
    return wall, ms, syncs


def _asvgd_steps(device, params):
    """ASVGD_RUN's annealed steps from the given particles on ``device``;
    the particles after them."""
    particles, cycles, steps = ASVGD_RUN
    args = stein_args(device)
    a = ASVGD(stein_gauss, Adagrad(0.5), RBFKernel(), num_stein_particles=particles,
              num_cycles=cycles, device=device)
    a.init(0, *args)
    # the state at the given particles
    state = SteinVIState(a.optim.init({k: v.to(device) for k, v in params.items()}),
                         torch.Generator(device=device))
    schedule = a._cyclical_annealing(steps, cycles, a.transition_speed,
                                     np.arange(steps, dtype=np.float32)).to(device)
    for t in range(steps):
        u = a.optim.get_params(state.optim_state)
        _, grads = a._annealed_loss_and_grads(schedule[t], state.rng_key, u, *args)
        state = state._replace(optim_state=a.optim.update(grads, state.optim_state))
    return a.get_params(state)["auto_x_loc"]


STEIN_KERNELS = {
    "RBFKernel": lambda: RBFKernel(),
    "RBFKernel vector": lambda: RBFKernel(mode="vector"),
    "RBFKernel matrix": lambda: RBFKernel(mode="matrix"),
    "IMQKernel": lambda: IMQKernel(),
    "LinearKernel": lambda: LinearKernel(),
    "RandomFeatureKernel": lambda: RandomFeatureKernel(),
    "MixtureKernel": lambda: MixtureKernel([0.5, 0.5], [RBFKernel(), IMQKernel()]),
    "GraphicalKernel": lambda: GraphicalKernel(local_kernel_fns={"auto_b_loc": IMQKernel()}),
    "RadialGaussNewtonKernel": lambda: RadialGaussNewtonKernel(),
}


def phase_stein_surface(device):
    """21c: ASVGD, the kernels' SVGD forces and a SteinVI step under
    ProbabilityProductKernel on the card against the CPU; returns the
    worst error of each in units of the tolerance."""
    cpu = torch.device("cpu")
    worst = {}
    particles, cycles, steps = ASVGD_RUN
    a = ASVGD(stein_gauss, Adagrad(0.5), RBFKernel(), num_stein_particles=particles,
              num_cycles=cycles, device=cpu)
    start = a.optim.get_params(a.init(213, *stein_args(cpu)).optim_state)
    got, want = _asvgd_steps(device, start), _asvgd_steps(cpu, start)
    worst["ASVGD"] = _close("ASVGD", got, want)
    mean_err = (got.mean(0).cpu() - torch.tensor([1.0, -1.0])).abs().max().item()
    log(f"[stein] 21c ASVGD, {particles} particles, {cycles} cycles, {steps} steps: the card "
        f"within {worst['ASVGD']:.3f} of rtol {STEIN_RTOL} of the CPU; particle mean off "
        f"[1, -1] by {mean_err:.4f} (the JAX test's gate 0.35)")
    if not mean_err < 0.35:
        raise SystemExit("21c: ASVGD's particle mean is off the Gaussian's")

    rng = np.random.default_rng(214)
    p = STEIN_FORCE_PARTICLES
    params = {"auto_a_loc": torch.from_numpy(rng.normal(0.0, 1.0, (p, 2)).astype(np.float32)),
              "auto_b_loc": torch.from_numpy(rng.normal(0.0, 1.0, (p,)).astype(np.float32))}
    rf = {k: torch.from_numpy(v.astype(np.float32))
          for k, v in (("w", rng.standard_normal((p, 3))), ("b", 2 * np.pi * rng.random((p, 3))))}
    for name, make in STEIN_KERNELS.items():
        out = {}
        for dev in (device, cpu):
            s = SVGD(stein_two, Adagrad(0.5), make(), num_stein_particles=p, device=dev)
            s.init(0, *stein_args(dev))
            for kf in getattr(s.kernel_fn, "kernel_fns", [s.kernel_fn]):
                if isinstance(kf, RandomFeatureKernel):
                    kf._random_weights, kf._random_biases = rf["w"].to(dev), rf["b"].to(dev)
            loss, grads = s._loss_and_grads(torch.Generator(device=dev), {
                k: v.to(dev) for k, v in params.items()}, *stein_args(dev))
            out[dev.type] = {"loss": loss, **grads}
        worst[name] = _close(name, out[device.type], out["cpu"])

    p, draws = STEIN_STEP_PARTICLES, 2
    out = {}
    tables = [rng.standard_normal((p, draws) + s).astype(np.float32) for s in ((2,), ())]
    for dev in (device, cpu):
        guide = autoguide.AutoNormal(stein_two)
        s = SteinVI(stein_two, guide, Adagrad(0.5), ProbabilityProductKernel(guide=guide),
                    num_stein_particles=p, num_elbo_particles=draws, device=dev)
        state = s.init(215, *stein_args(dev))
        if not out:
            start = s.optim.get_params(state.optim_state)
        source = TableDraws([torch.from_numpy(t).to(dev) for t in tables],
                            generator=torch.Generator(device=dev))
        u = {k: v.to(dev) for k, v in start.items()}
        loss, grads = s._loss_and_grads(source, u, *stein_args(dev))
        out[dev.type] = {"loss": loss, **grads}
    worst["SteinVI ProbabilityProductKernel"] = _close("SteinVI", out[device.type], out["cpu"])
    log(f"[stein] 21c the card against the CPU, in units of rtol {STEIN_RTOL} (SVGD forces at "
        f"{STEIN_FORCE_PARTICLES} particles, a SteinVI step at {STEIN_STEP_PARTICLES} on the "
        f"same draws): " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    return worst


def phase_twenty_one(X, y, true_w, posterior, kernels):
    """Phase 21: SVGD on covtype, examples/stein_bnn.py and the rest of the
    einstein module on the card; returns the walls of its legs, the ms and
    host syncs per step of 21a and 21b and 21a's glm_split launches."""
    t0 = time.perf_counter()
    wall_a, ms_a, syncs_a, launches = phase_svgd_covtype(X, y, true_w, posterior, kernels)
    t1 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    wall_b, ms_b, syncs_b = phase_stein_bnn(X.device)
    t2 = time.perf_counter()
    phase_stein_surface(X.device)
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("21b-c: launched a GLM kernel")
    walls = {"21a": t1 - t0, "21b": t2 - t1, "21c": time.perf_counter() - t2}
    return walls, {"21a": ms_a, "21b": ms_b}, {"21a": syncs_a, "21b": syncs_b}, launches


def phase_horseshoe(X, y, beta_true, leg):
    """7b-7d: one MCMC(NUTS) run of the horseshoe; returns the MCMC object."""
    chains, warmup, samples, depth, nuts_kw = HS_RUNS[leg]
    mcmc = MCMC(NUTS(model_horseshoe, max_tree_depth=depth, **nuts_kw), num_warmup=warmup,
                num_samples=samples, num_chains=chains)
    mcmc.run(11, X, y, extra_fields=("diverging",))
    stats = mcmc.last_run_stats
    draws = mcmc.get_samples(group_by_chain=True)["beta"]
    if draws.shape != (chains, samples, HS_DATA[1]) or not torch.isfinite(draws).all():
        raise SystemExit(f"7 {leg}: bad draws, shape {tuple(draws.shape)}")
    err = np.abs(draws.double().mean((0, 1)).cpu().numpy() - beta_true).max()
    rhat = split_gelman_rubin(draws).max().item()
    divergent = mcmc.get_extra_fields()["diverging"].float().mean().item()
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    ms = (stats["warmup_s"] + stats["sample_s"]) / evals * 1e3
    log(f"[dense] horseshoe {leg}, {chains} chains, {warmup} + {samples}, max_tree_depth "
        f"{depth}, {nuts_kw}: warmup {stats['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} "
        f"s, potential evaluations {stats['potential_evals_warmup']} + "
        f"{stats['potential_evals_sample']}, {ms:.2f} ms per evaluation on the host's clock; "
        f"max |mean(beta) - beta_true| {err:.4f} (gate {HS_GATE}); split R-hat of beta max "
        f"{rhat:.4f}; "
        f"divergent share {divergent:.4f}")
    if leg != "forward" and not err < HS_GATE:
        raise SystemExit(f"7 {leg}: posterior means of beta off by {err:.4f} (>= {HS_GATE})")
    return mcmc, rhat


def phase_dense(X, y, true_w):
    """Phase 7; returns the dense covtype leg's stats and its launch counts."""
    device = X.device
    phase_dense_gauss(device)
    Xh, yh, beta_true = horseshoe_data(device)

    _, rhat = phase_horseshoe(Xh, yh, beta_true, "dense")
    if not rhat < HS_RHAT_GATE:
        raise SystemExit(f"7b: R-hat of beta {rhat:.4f} (>= {HS_RHAT_GATE})")

    mcmc, _ = phase_horseshoe(Xh, yh, beta_true, "structured")
    chains = HS_RUNS["structured"][0]
    want = {("beta", "lambda"): (chains, 40, 40), ("sigma", "tau"): (chains, 2)}
    inv = mcmc.last_state.adapt_state.inverse_mass_matrix
    got = {k: tuple(v.shape) for k, v in inv.items()} if isinstance(inv, dict) else inv.shape
    log(f"[dense] 7c exposed inverse mass: {got}")
    if got != want:
        raise SystemExit(f"7c: exposed inverse mass {got}, expected {want}")

    mcmc, _ = phase_horseshoe(Xh, yh, beta_true, "forward")
    z = mcmc.last_state.z
    layout = FlatLayout({k: v[0] for k, v in z.items()})
    pe_fn = mcmc.sampler._potential_fn_gen(Xh, yh)
    panel = layout.ravel_batch(z)
    by_mode = {}
    for forward in (True, False):
        pe_grad = batched_potential(pe_fn, layout, forward_mode=forward)
        pe_grad(panel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        by_mode[forward] = pe_grad(panel)
        torch.cuda.synchronize()
        by_mode[forward] += ((time.perf_counter() - t0) * 1e3,)
    (pe_f, g_f, ms_f), (pe_r, g_r, ms_r) = by_mode[True], by_mode[False]
    g_err = (g_f - g_r).abs().max().item()
    log(f"[dense] 7d one batched evaluation at {tuple(panel.shape)}: forward mode {ms_f:.2f} ms, "
        f"reverse mode {ms_r:.2f} ms on the host's clock; gradient max abs difference "
        f"{g_err:.3e} on components up to {g_r.abs().max().item():.3e} (rtol 1e-5, atol 1e-5)")
    if not (torch.allclose(g_f, g_r, rtol=1e-5, atol=1e-5)
            and torch.allclose(pe_f, pe_r, rtol=1e-5, atol=1e-5)):
        raise SystemExit("7d: forward- and reverse-mode gradients disagree")

    glm.reset_launch_counts()
    stats = phase_main(X, y, true_w, "glm_split", run=DENSE_COVTYPE, tag="dense",
                       dense_mass=True, pooled_adaptation=True)
    return stats, dict(glm.launch_counts)


def mc_moments(draws):
    """Posterior mean and std of every coordinate of ``(C, n, ...)`` draws,
    each with its Monte-Carlo standard error: ``sd / sqrt(ESS)`` for the
    mean, and for the std the error of the mean of the squared deviations
    (from their own ESS) over ``2 sd``."""
    x = torch.tensor(np.asarray(draws), dtype=torch.float64)
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    mean, sd = flat.mean(0), flat.std(0)
    sq = (x - mean) ** 2
    sq_flat = sq.reshape(flat.shape)
    out = {"mean": mean, "std": sd, "se_mean": sd / effective_sample_size(x).sqrt(),
           "se_std": sq_flat.std(0) / effective_sample_size(sq).sqrt() / (2 * sd)}
    return {k: v.tolist() for k, v in out.items()}


def eight_schools(y, sigma):
    """``examples/eight_schools.py::model``."""
    mu = npt.sample("mu", dist.Normal(0.0, 5.0))
    tau = npt.sample("tau", dist.HalfCauchy(5.0))
    with npt.plate("J", 8):
        theta = npt.sample("theta", dist.Normal(mu, tau))
        npt.sample("obs", dist.Normal(theta, sigma), obs=y)


def phase_eight_schools(device):
    """Phase 9; returns its wall seconds."""
    t0 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    y = torch.tensor(ES_Y, device=device)
    sigma = torch.tensor(ES_SIGMA, device=device)
    model_nc = handlers.reparam(eight_schools, config={"theta": LocScaleReparam(0)})
    chains, warmup, samples, depth = ES_RUN
    mcmc = MCMC(NUTS(model_nc, target_accept_prob=0.9, max_tree_depth=depth),
                num_warmup=warmup, num_samples=samples, num_chains=chains)
    mcmc.run(9, y, sigma, extra_fields=("diverging",))
    stats = mcmc.last_run_stats
    z = mcmc.get_samples(group_by_chain=True)
    if z["theta"].shape != (chains, samples, 8) or z["theta"].device.type != device.type:
        raise SystemExit(f"9: theta {tuple(z['theta'].shape)} on {z['theta'].device}")
    if not all(torch.isfinite(v).all() for v in z.values()):
        raise SystemExit("9: draws that are not finite")
    mcmc.print_summary()
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    ms = (stats["warmup_s"] + stats["sample_s"]) / evals * 1e3
    log(f"[8 schools] {chains} chains, {warmup} + {samples}, max_tree_depth {depth}: init {stats['init_s']:.2f} s, "
        f"warmup {stats['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} s; potential "
        f"evaluations {stats['potential_evals_warmup']} + {stats['potential_evals_sample']} "
        f"({evals / (warmup + samples):.1f} a transition), {ms:.2f} ms per evaluation")
    within = True
    for site in ("mu", "tau", "theta"):
        got, ref = mc_moments(z[site].cpu()), EIGHT_SCHOOLS_REF[site]
        for m in ("mean", "std"):
            gap = np.abs(np.subtract(got[m], ref[m]))
            bound = 4 * np.hypot(got["se_" + m], ref["se_" + m])
            # a NaN error (no spread in the draws) fails the comparison
            within = within and bool(np.all(gap < bound))
            log(f"[8 schools] {m} of {site}: port {np.round(got[m], 3).tolist()}, JAX "
                f"{np.round(ref[m], 3).tolist()}; largest gap / 4 combined errors "
                f"{float((gap / bound).max()):.3f}")
    if not within:
        raise SystemExit("9: the posterior is off the JAX package's by more than 4 "
                         "Monte-Carlo standard errors")

    flat = mcmc.get_samples()
    n = chains * samples
    pred = Predictive(model_nc, flat, return_sites=["obs"])(10, None, sigma)["obs"]
    resid = (pred - flat["theta"]) / sigma
    mean_z = resid.mean(0).abs().max().item()
    std_z = (resid.std(0) - 1).abs().max().item()
    log(f"[8 schools] Predictive obs {tuple(pred.shape)}: max |mean((obs - theta) / sigma)| "
        f"{mean_z:.4f} (gate {4 / np.sqrt(n):.4f}), max |std - 1| {std_z:.4f} (gate "
        f"{4 / np.sqrt(2 * n):.4f})")
    if pred.shape != (n, 8) or not torch.isfinite(pred).all():
        raise SystemExit(f"9: Predictive obs {tuple(pred.shape)}")
    if not (mean_z < 4 / np.sqrt(n) and std_z < 4 / np.sqrt(2 * n)):
        raise SystemExit("9: Predictive's obs are not theta + sigma * N(0, 1)")
    ll = log_likelihood(model_nc, flat, y, sigma)["obs"]
    ref = dist.Normal(flat["theta"], sigma).log_prob(y)
    ll_rel = ((ll - ref).abs() / ref.abs()).max().item()
    log(f"[8 schools] log_likelihood obs {tuple(ll.shape)}: max rel err against "
        f"Normal(theta, sigma).log_prob(y) {ll_rel:.3e} (gate 1e-5)")
    if ll.shape != (n, 8) or not torch.isfinite(ll).all() or not ll_rel <= 1e-5:
        raise SystemExit("9: log_likelihood disagrees")

    lr, steps, draws = ES_SVI
    guide = autoguide.AutoNormal(model_nc)
    svi = SVI(model_nc, guide, Adam(lr), Trace_ELBO())
    res = svi.run(12, steps, y, sigma)
    got = Predictive(model_nc, guide=guide, params=res.params, num_samples=draws,
                     return_sites=["mu", "tau", "theta_decentered", "theta", "obs"])(
        13, None, sigma)
    theta = got["mu"][:, None] + got["tau"][:, None] * got["theta_decentered"]
    th_err = (got["theta"] - theta).abs().max().item()
    losses = res.losses.cpu()
    log(f"[8 schools] AutoNormal, {steps} steps: loss of the first 50 "
        f"{losses[:50].mean().item():.2f}, of the last 50 {losses[-50:].mean().item():.2f}; "
        f"Predictive through the guide obs {tuple(got['obs'].shape)}, mean of mu "
        f"{got['mu'].mean().item():.3f}, theta against mu + tau theta_decentered {th_err:.2e}")
    if got["obs"].shape != (draws, 8) or not all(torch.isfinite(v).all() for v in got.values()):
        raise SystemExit("9: Predictive through the guide")
    if not (th_err < 1e-4 and torch.isfinite(losses).all()):
        raise SystemExit("9: the guide's predictive draws break theta's definition")
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("9: 8-schools launched a GLM kernel")
    wall = time.perf_counter() - t0
    log(f"[8 schools] phase 9: {wall:.1f} s (budget 20 s at 24.0 ms per ECS evaluation)")
    return wall


def sv_data(T=SV_T, seed=0):
    """``examples/stochastic_volatility.py:28-29`` in numpy: returns with a
    Gaussian random-walk log volatility, and that log volatility."""
    rng = np.random.default_rng(seed)
    log_vol = 0.1 * np.cumsum(rng.standard_normal(T)) * 0.3 - 2
    returns = np.exp(log_vol) * rng.standard_normal(T)
    return returns.astype(np.float32), log_vol


def stochastic_volatility(returns):
    """``examples/stochastic_volatility.py::model``."""
    T = returns.shape[0]
    sigma = npt.sample("sigma", dist.Exponential(50.0))
    nu = npt.sample("nu", dist.Exponential(0.1))
    s = npt.sample("s", dist.GaussianRandomWalk(scale=sigma, num_steps=T))
    npt.sample("r", dist.StudentT(df=nu, loc=0.0, scale=torch.exp(s)), obs=returns)


def phase_sv(device):
    """Phase 10; returns its wall seconds."""
    t0 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    returns, log_vol = sv_data()
    chains, warmup, samples, depth = SV_RUN
    mcmc = MCMC(NUTS(stochastic_volatility, max_tree_depth=depth, pooled_adaptation=True),
                num_warmup=warmup, num_samples=samples, num_chains=chains)
    mcmc.run(14, torch.from_numpy(returns).to(device), extra_fields=("diverging",))
    stats = mcmc.last_run_stats
    z = mcmc.get_samples(group_by_chain=True)
    if z["s"].shape != (chains, samples, SV_T) or z["s"].device.type != device.type:
        raise SystemExit(f"10: s {tuple(z['s'].shape)} on {z['s'].device}")
    if not all(torch.isfinite(v).all() for v in z.values()):
        raise SystemExit("10: draws that are not finite")
    err = np.abs(z["s"].double().mean((0, 1)).cpu().numpy() - log_vol).max()
    rhat = split_gelman_rubin(z["sigma"]).item()
    divergent = mcmc.get_extra_fields()["diverging"].float().mean().item()
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    ms = (stats["warmup_s"] + stats["sample_s"]) / evals * 1e3
    log(f"[sv] T = {SV_T}, {chains} chains, {warmup} + {samples}, max_tree_depth {depth}, "
        f"pooled: init {stats['init_s']:.2f} s, warmup {stats['warmup_s']:.2f} s, sampling "
        f"{stats['sample_s']:.2f} s; potential evaluations {stats['potential_evals_warmup']} + "
        f"{stats['potential_evals_sample']} ({stats['potential_evals_warmup'] / warmup:.1f} / "
        f"{stats['potential_evals_sample'] / samples:.1f} a transition), {ms:.2f} ms per "
        f"evaluation; max |mean(s) - log vol| {err:.4f} (gate {SV_GATE}); R-hat of sigma "
        f"{rhat:.4f} (gate {SV_RHAT_GATE}); mean sigma {z['sigma'].mean().item():.4f}, nu "
        f"{z['nu'].mean().item():.2f}; divergent share {divergent:.4f}")
    if not err < SV_GATE:
        raise SystemExit(f"10: posterior mean of s off the log volatility by {err:.4f}")
    if not rhat < SV_RHAT_GATE:
        raise SystemExit(f"10: R-hat of sigma {rhat:.4f} (>= {SV_RHAT_GATE})")
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("10: stochastic volatility launched a GLM kernel")
    wall = time.perf_counter() - t0
    log(f"[sv] phase 10: {wall:.1f} s (budget 30 s at 24.0 ms per ECS evaluation)")
    return wall


def hmm_data(T=HMM_T, seed=0):
    """``examples/hmm_enum.py::make_data``, with the generating states."""
    rng = np.random.RandomState(seed)
    p0 = np.array([0.6, 0.4])
    trans = np.array([[0.85, 0.15], [0.25, 0.75]])
    zs = [rng.choice(2, p=p0)]
    for _ in range(1, T):
        zs.append(rng.choice(2, p=trans[zs[-1]]))
    zs = np.array(zs)
    ys = np.array(HMM_LOCS)[zs] + 0.3 * rng.randn(T)
    return ys.astype(np.float32), zs


def hmm_model(ys):
    """``examples/hmm_enum.py::model``: the chain through ``markov``."""
    T = ys.shape[0]
    probs = npt.sample("trans", dist.Dirichlet(torch.ones((2, 2), device=ys.device)).to_event(1))
    locs = torch.tensor(HMM_LOCS, device=ys.device)
    sigma = npt.sample("sigma", dist.HalfNormal(torch.tensor(1.0, device=ys.device)))
    z = npt.sample("z_0", dist.Categorical(torch.tensor([0.5, 0.5], device=ys.device)),
                   infer={"enumerate": "parallel"})
    npt.sample("y_0", dist.Normal(locs[z], sigma), obs=ys[0])
    for t in markov(range(1, T), history=1):
        z = npt.sample(f"z_{t}", dist.Categorical(probs[z]), infer={"enumerate": "parallel"})
        npt.sample(f"y_{t}", dist.Normal(locs[z], sigma), obs=ys[t])


def hmm_scan_model(ys):
    """``examples/hmm_enum.py::scan_model``: the chain through ``scan``."""
    probs = npt.sample("trans", dist.Dirichlet(torch.ones((2, 2), device=ys.device)).to_event(1))
    locs = torch.tensor(HMM_LOCS, device=ys.device)
    sigma = npt.sample("sigma", dist.HalfNormal(torch.tensor(1.0, device=ys.device)))

    def transition(z_prev, y):
        z = npt.sample("z", dist.Categorical(probs[z_prev]), infer={"enumerate": "parallel"})
        npt.sample("y", dist.Normal(locs[z], sigma), obs=y)
        return z, None

    scan(transition, 0, ys)


def hmm_log_joint(ys, trans, sigma, init):
    """The log joint of the HMM with the states summed out, in float64 numpy
    and scipy: the forward algorithm from ``init``, two Dirichlet(1, 1) rows
    and a HalfNormal(1)."""
    from scipy import stats
    from scipy.special import logsumexp

    ys, trans, sigma = (np.asarray(a, np.float64) for a in (ys, trans, sigma))
    emit = stats.norm(np.array(HMM_LOCS), sigma).logpdf(ys[:, None])
    alpha = np.log(init) + emit[0]
    for t in range(1, len(ys)):
        alpha = logsumexp(alpha[:, None] + np.log(trans), axis=0) + emit[t]
    # scipy wants rows that sum to 1 in float64: a float32 draw's rows do not
    prior = sum(stats.dirichlet(np.ones(2)).logpdf(row / row.sum()) for row in trans)
    return logsumexp(alpha) + prior + stats.halfnorm().logpdf(sigma)


def hmm_decode_share(pred, zs):
    """The share of steps whose most frequent decoded state is the
    generating one."""
    z = torch.stack([pred[f"z_{t}"] for t in range(len(zs))], -1).float()
    mode = (z.mean(0) > 0.5).long().cpu().numpy()
    return float((mode == zs).mean())


def phase_hmm(device):
    """Phase 11; returns its wall seconds."""
    t0 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    ys_np, zs = hmm_data()
    ys = torch.from_numpy(ys_np).to(device)

    def gap(means):
        return float(np.abs(np.subtract(means, HMM_TRUE)).max())

    def run(model_fn, config, seed, tag):
        chains, warmup, samples, depth = config
        mcmc = MCMC(NUTS(model_fn, max_tree_depth=depth), num_warmup=warmup,
                    num_samples=samples, num_chains=chains)
        t = time.perf_counter()
        mcmc.run(seed, ys)
        wall = time.perf_counter() - t
        stats = mcmc.last_run_stats
        z = mcmc.get_samples(group_by_chain=True)
        if sorted(z) != ["sigma", "trans"] or z["trans"].shape != (chains, samples, 2, 2):
            raise SystemExit(f"11{tag}: samples {({k: tuple(v.shape) for k, v in z.items()})}")
        if not all(torch.isfinite(v).all() for v in z.values()):
            raise SystemExit(f"11{tag}: draws that are not finite")
        evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
        ms = (stats["warmup_s"] + stats["sample_s"]) / evals * 1e3
        means = [z["trans"][..., 0, 0].mean().item(), z["trans"][..., 1, 1].mean().item(),
                 z["sigma"].mean().item()]
        log(f"[hmm] 11{tag} {model_fn.__name__}, {chains} chains, {warmup} + {samples}, "
            f"max_tree_depth {depth}: {wall:.2f} s (init {stats['init_s']:.2f}, warmup "
            f"{stats['warmup_s']:.2f}, sampling {stats['sample_s']:.2f}); potential "
            f"evaluations {stats['potential_evals_warmup']} + {stats['potential_evals_sample']}, "
            f"{ms:.2f} ms per evaluation; means of trans[0, 0], trans[1, 1], sigma "
            f"{np.round(means, 4).tolist()} (generating {list(HMM_TRUE)})")
        return mcmc, means

    # (a) the scan form at full size
    mcmc, means = run(hmm_scan_model, HMM_RUN, 21, "a")
    err = gap(means)
    log(f"[hmm] 11a largest gap {err:.4f} (gate {HMM_GATE})")
    if not err < HMM_GATE:
        raise SystemExit(f"11a: posterior means off the generating values by {err:.4f}")
    # (b) the markov form, short
    run(hmm_model, HMM_OTHER, 22, "b")

    # (c) the enumerated density of each form against numpy at 8 draws, the
    # 8 in one vmap as a run evaluates them
    flat = mcmc.get_samples()
    pick = torch.linspace(0, flat["sigma"].shape[0] - 1, 8).long().to(device)
    points = {k: v[pick] for k, v in flat.items()}
    worst = 0.0
    for model_fn, first in ((hmm_model, False), (hmm_scan_model, True)):
        wrapped = enum(config_enumerate(model_fn), first_available_dim=-1)
        got = torch.func.vmap(lambda p: enum_log_density(wrapped, (ys,), {}, p)[0])(points)
        for j in range(8):
            trans = points["trans"][j].double().cpu().numpy()
            init = trans[0] if first else np.array([0.5, 0.5])
            want = hmm_log_joint(ys_np, trans, points["sigma"][j].item(), init)
            worst = max(worst, abs(got[j].item() - want) / abs(want))
    log(f"[hmm] 11c enumerated log joint of both forms at 8 draws against the numpy "
        f"forward algorithm: max rel err {worst:.2e} (gate 1e-5)")
    if not worst <= 1e-5:
        raise SystemExit(f"11c: enumerated log density off by {worst:.2e}")

    # (d) SVI under TraceEnum_ELBO on the scan form
    lr, steps = HMM_SVI
    guide = autoguide.AutoNormal(hmm_scan_model)
    svi = SVI(hmm_scan_model, guide, Adam(lr), TraceEnum_ELBO())
    t = time.perf_counter()
    with warnings.catch_warnings():
        # the autoguide warns once per discrete site that it leaves to the ELBO
        warnings.simplefilter("ignore")
        res = svi.run(23, steps, ys)
    wall = time.perf_counter() - t
    med = guide.median(res.params)
    svi_err = gap([med["trans"][0, 0].item(), med["trans"][1, 1].item(), med["sigma"].item()])
    log(f"[hmm] 11d AutoNormal, TraceEnum_ELBO, Adam({lr}), {steps} steps: {wall:.2f} s, "
        f"{wall / steps * 1e3:.2f} ms a step; loss of the last 50 "
        f"{res.losses[-50:].mean().item():.3f}; largest gap of the medians {svi_err:.4f} "
        f"(gate {HMM_SVI_GATE})")
    if not (torch.isfinite(res.losses).all() and svi_err < HMM_SVI_GATE):
        raise SystemExit(f"11d: the guide's medians off the generating values by {svi_err:.4f}")

    # (e) decoding: the states' posterior given (a)'s draws
    t = time.perf_counter()
    pred = Predictive(hmm_model, flat, infer_discrete=True, parallel=True)(24, ys)
    wall = time.perf_counter() - t
    share = hmm_decode_share(pred, zs)
    n = flat["sigma"].shape[0]
    log(f"[hmm] 11e Predictive(infer_discrete=True) of {n} draws: {wall:.2f} s; share of "
        f"steps whose posterior mode is the generating state {share:.4f} (gate "
        f"{HMM_DECODE_GATE})")
    if pred["z_1"].shape != (n,) or not share >= HMM_DECODE_GATE:
        raise SystemExit(f"11e: decoded share {share:.4f}")
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("11: the HMM launched a GLM kernel")
    wall = time.perf_counter() - t0
    log(f"[hmm] phase 11: {wall:.1f} s (budget 25 s at 24.0 ms per ECS evaluation)")
    return wall


GIBBS_PROBS = (0.15, 0.3, 0.3, 0.25)
GIBBS_LOCS = (-1.0, 0.0, 1.0, 2.0)
MIXED_PROBS = (0.3, 0.7)
MIXED_LOCS = (-0.5, 1.0)


def gibbs_mixture(probs, locs):
    """``tests/infer/test_hmc_gibbs.py``'s mixture (scale 0.5)."""
    c = npt.sample("c", dist.Categorical(probs))
    npt.sample("x", dist.Normal(locs[c], 0.5))


def mixed_mixture(probs, locs):
    """``tests/infer/test_mixed_hmc.py``'s first mixture (scale 0.8)."""
    c = npt.sample("c", dist.Categorical(probs))
    npt.sample("x", dist.Normal(locs[c], 0.8))


def gauss_model(y):
    """``tests/infer/test_smc.py``'s conjugate Gaussian."""
    mu = npt.sample("mu", dist.Normal(0.0, 1.0))
    with npt.plate("N", y.shape[0]):
        npt.sample("y", dist.Normal(mu, 1.0), obs=y)


def gauss_log_evidence(y):
    """log N(y; 0, I + 1 1^T), the exact evidence of ``gauss_model``."""
    n = len(y)
    cov = np.eye(n) + np.ones((n, n))
    _, logdet = np.linalg.slogdet(cov)
    y = np.asarray(y, np.float64)
    return float(-0.5 * (y @ np.linalg.solve(cov, y) + logdet + n * np.log(2 * np.pi)))


def schools_gaps(samples):
    """The posterior means of ``mu`` and ``tau`` and their gaps to
    ``EIGHT_SCHOOLS_REF``'s."""
    means = {site: samples[site].double().mean().item() for site in ("mu", "tau")}
    return means, {site: abs(means[site] - EIGHT_SCHOOLS_REF[site]["mean"]) for site in means}


def phase_samplers(device, ecs_ms):
    """Phase 12; returns its wall seconds."""
    t0 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    y = torch.tensor(ES_Y, device=device)
    sigma = torch.tensor(ES_SIGMA, device=device)
    model_nc = handlers.reparam(eight_schools, config={"theta": LocScaleReparam(0)})

    def leg(tag, what, fn):
        evals0 = infer_util.potential_evals
        t = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        evals = infer_util.potential_evals - evals0
        log(f"[samplers] 12{tag} {what}: {wall:.2f} s, {evals} evaluations, "
            f"{wall / max(evals, 1) * 1e3:.2f} ms per evaluation")
        return out

    def hold(tag, gaps, gates):
        log(f"[samplers] 12{tag} gaps of the means of mu, tau to EIGHT_SCHOOLS_REF "
            f"{[round(gaps[k], 4) for k in ('mu', 'tau')]} (gates "
            f"{[gates[k] for k in ('mu', 'tau')]})")
        if not all(gaps[k] < gates[k] for k in gates):
            raise SystemExit(f"12{tag}: posterior means off EIGHT_SCHOOLS_REF: {gaps}")

    # (a) SMC on 8-schools
    res = leg("a", f"SMC, 8-schools non-centred, {SMC_RUN} particles",
              lambda: SMC(model_nc, num_particles=SMC_RUN).run(31, y, sigma))
    if sorted(res.samples) != ["mu", "tau", "theta_decentered"] or res.samples["mu"].shape != (
            SMC_RUN,) or not all(torch.isfinite(v).all() for v in res.samples.values()):
        raise SystemExit(f"12a: samples {({k: tuple(v.shape) for k, v in res.samples.items()})}")
    means, gaps = schools_gaps(res.samples)
    ev_gap = abs(res.log_evidence - SMC_EVIDENCE[0])
    log(f"[samplers] 12a {len(res.betas) - 1} stages, means {[round(means[k], 3) for k in means]}, "
        f"log evidence {res.log_evidence:.4f} (JAX's key 0 {SMC_EVIDENCE[0]}, gap {ev_gap:.4f}, "
        f"gate {SMC_EVIDENCE[1]})")
    hold("a", gaps, SMC_GATE)
    if not ev_gap < SMC_EVIDENCE[1]:
        raise SystemExit(f"12a: log evidence {res.log_evidence:.4f}")

    # (b) SMC's evidence on the conjugate Gaussian
    yg = (0.5, 1.5, 1.0, 0.8, 1.2)
    particles, steps = SMC_GAUSS
    res = leg("b", f"SMC, conjugate Gaussian, {particles} particles, {steps} MH steps",
              lambda: SMC(gauss_model, num_particles=particles, num_mcmc_steps=steps).run(
                  32, torch.tensor(yg, device=device)))
    exact = gauss_log_evidence(yg)
    log(f"[samplers] 12b log evidence {res.log_evidence:.4f}, exact {exact:.4f} (gate 0.2)")
    if not abs(res.log_evidence - exact) < 0.2 or res.betas[-1] != 1.0:
        raise SystemExit(f"12b: log evidence {res.log_evidence:.4f} against {exact:.4f}")

    def mixture_moments(tag, x, probs, locs, scale, mean_gate, var_gate):
        p, m = np.asarray(probs), np.asarray(locs)
        true_mean = float(p @ m)
        true_var = float(p @ (m - true_mean) ** 2) + scale**2
        got_mean, got_var = x.double().mean().item(), x.double().var().item()
        log(f"[samplers] 12{tag} mean of x {got_mean:.4f} (exact {true_mean:.4f}, gate "
            f"{mean_gate}), var {got_var:.4f} (exact {true_var:.4f}, gate {var_gate})")
        if not (abs(got_mean - true_mean) < mean_gate and abs(got_var - true_var) < var_gate):
            raise SystemExit(f"12{tag}: the mixture's moments are off")

    # (c) DiscreteHMCGibbs(NUTS) on a 4-component mixture
    chains, warmup, samples, depth = GIBBS_RUN
    probs = torch.tensor(GIBBS_PROBS, device=device)
    locs = torch.tensor(GIBBS_LOCS, device=device)
    mcmc = MCMC(DiscreteHMCGibbs(NUTS(gibbs_mixture, max_tree_depth=depth)), num_warmup=warmup,
                num_samples=samples, num_chains=chains)
    leg("c", f"DiscreteHMCGibbs(NUTS), {chains} chains, {warmup} + {samples}, depths {depth}",
        lambda: mcmc.run(33, probs, locs))
    z = mcmc.get_samples()
    if z["c"].shape != (chains * samples,) or z["c"].dtype != torch.int64:
        raise SystemExit(f"12c: c {tuple(z['c'].shape)} {z['c'].dtype}")
    mixture_moments("c", z["x"], GIBBS_PROBS, GIBBS_LOCS, 0.5, 0.1, 0.3)

    # (d) MixedHMC on a 2-component mixture
    chains, warmup, samples = MIXED_RUN
    probs = torch.tensor(MIXED_PROBS, device=device)
    locs = torch.tensor(MIXED_LOCS, device=device)
    mcmc = MCMC(MixedHMC(HMC(mixed_mixture, trajectory_length=1.2), num_discrete_updates=4),
                num_warmup=warmup, num_samples=samples, num_chains=chains)
    leg("d", f"MixedHMC(HMC), {chains} chains, {warmup} + {samples}",
        lambda: mcmc.run(34, probs, locs))
    z = mcmc.get_samples()
    freqs = torch.bincount(z["c"], minlength=2).double().cpu().numpy() / z["c"].numel()
    log(f"[samplers] 12d frequencies of c {np.round(freqs, 4).tolist()} (exact "
        f"{list(MIXED_PROBS)}, gate 0.06)")
    if not np.all(np.abs(freqs - np.asarray(MIXED_PROBS)) < 0.06):
        raise SystemExit("12d: the discrete site's frequencies are off")
    mixture_moments("d", z["x"], MIXED_PROBS, MIXED_LOCS, 0.8, 0.1, 0.2)

    # (e) the gradient-free and ensemble kernels, and (f) sequential chains
    makers = {"BarkerMH": BarkerMH, "SA": SA, "AIES": AIES, "ESS": ESS}
    for i, (name, (chains, warmup, samples)) in enumerate(KERNEL_RUNS.items()):
        mcmc = MCMC(makers[name](model_nc), num_warmup=warmup, num_samples=samples,
                    num_chains=chains)
        leg("e", f"{name}, 8-schools non-centred, {chains} chains, {warmup} + {samples}",
            lambda: mcmc.run(35 + i, y, sigma))
        z = mcmc.get_samples(group_by_chain=True)
        if z["theta"].shape != (chains, samples, 8) or not torch.isfinite(z["theta"]).all():
            raise SystemExit(f"12e {name}: theta {tuple(z['theta'].shape)}")
        hold(f"e {name}", schools_gaps(z)[1], KERNEL_GATES[name])
    chains, warmup, samples = SEQ_RUN
    mcmc = MCMC(BarkerMH(model_nc), num_warmup=warmup, num_samples=samples, num_chains=chains,
                chain_method="sequential")
    leg("f", f"BarkerMH, sequential, {chains} chains, {warmup} + {samples}",
        lambda: mcmc.run(40, y, sigma))
    z = mcmc.get_samples(group_by_chain=True)
    if z["theta"].shape != (chains, samples, 8) or torch.equal(z["mu"][0], z["mu"][1]):
        raise SystemExit(f"12f: theta {tuple(z['theta'].shape)}, or the chains are one")
    hold("f", schools_gaps(z)[1], KERNEL_GATES["sequential"])

    if launches0 != dict(glm.launch_counts):
        raise SystemExit("12: a sampler launched a GLM kernel")
    wall = time.perf_counter() - t0
    log(f"[samplers] phase 12: {wall:.1f} s, about {wall * 24.0 / ecs_ms:.1f} s on a host where "
        f"the ECS leg takes 24.0 ms per evaluation (here {ecs_ms:.2f}; budget 20 s)")
    return wall


def phase_chees(X, y, true_w, nuts):
    """13a: ChEES on the covtype model in split mode; returns its glm_split
    launches (``nuts``: phase 4's split-mode stats)."""
    chains, warmup, samples, max_steps, step_size, traj = CHEES_RUN
    data = glm.prepare_glm_data(X, y, dtype="split")
    mcmc = MCMC(CheesHMC(model, step_size=step_size, trajectory_length=traj,
                         max_num_steps=max_steps),
                num_warmup=warmup, num_samples=samples, num_chains=chains)
    before = dict(glm.launch_counts)
    mcmc.run(13, data, extra_fields=("num_steps", "accept_prob"))
    launches = {k: v - before[k] for k, v in glm.launch_counts.items()}
    stats = mcmc.last_run_stats
    draws = mcmc.get_samples(group_by_chain=True)["w"]
    extra = mcmc.get_extra_fields(group_by_chain=True)
    if draws.shape != (chains, samples, D) or not torch.isfinite(draws).all():
        raise SystemExit(f"13a: bad draws, shape {tuple(draws.shape)}")
    err = (draws.mean((0, 1)).cpu() - torch.from_numpy(true_w)).abs().max().item()
    adapt = mcmc.last_state.adapt_state
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    wall = stats["warmup_s"] + stats["sample_s"]
    steps = extra["num_steps"][0].double()
    nuts_evals = nuts["potential_evals_sample"] / RUNS["glm_split"][1]
    nuts_s = nuts["sample_s"] / RUNS["glm_split"][1]
    log(f"[chees] 13a CheesHMC, covtype split mode, {chains} chains, {warmup} + {samples}, "
        f"max_num_steps {max_steps}: init {stats['init_s']:.2f} s, warmup {stats['warmup_s']:.2f} "
        f"s, sampling {stats['sample_s']:.2f} s; evaluations {stats['potential_evals_init']} + "
        f"{stats['potential_evals_warmup']} + {stats['potential_evals_sample']}; glm_split "
        f"launches {launches['glm_split']}; {wall / evals * 1e3:.2f} ms per evaluation; pooled "
        f"accept {extra['accept_prob'].mean().item():.4f}; final step size "
        f"{adapt.step_size.item():.5f}, trajectory length {adapt.trajectory_length.item():.5f}; "
        f"leapfrog steps a sampling transition {steps.mean().item():.2f} (min "
        f"{steps.min().item():.0f}, max {steps.max().item():.0f}); a sampling transition "
        f"(one draw of every chain): {stats['potential_evals_sample'] / samples:.2f} evaluations "
        f"and {stats['sample_s'] / samples:.3f} s, against NUTS's {nuts_evals:.2f} and "
        f"{nuts_s:.3f} s (phase 4, split mode, {CHAINS} chains); max |mean(w) - true_w| "
        f"{err:.4f} (gate {CHEES_GATE})")
    if launches["glm_split"] != stats["potential_evals"] + CHEES_INIT_TRACES or any(
            v for k, v in launches.items() if k != "glm_split"):
        raise SystemExit(f"13a: launched {launches} for {stats['potential_evals']} evaluations "
                         f"and {CHEES_INIT_TRACES} init traces")
    if not err < CHEES_GATE:
        raise SystemExit(f"13a: posterior means off by {err:.4f} (>= {CHEES_GATE})")
    return launches["glm_split"]


def tg_model(mus, data):
    """``tests/infer/test_gradient.py``'s model: a Bernoulli latent picks
    the mean of an observed Normal."""
    z = npt.sample("z", dist.Bernoulli(0.3))
    npt.sample("x", dist.Normal(mus[z.long()], 1.0), obs=data)


def tg_exact_loss(phi, mus, data):
    """Minus the ELBO of ``tg_model`` under ``Bernoulli(logits=phi)``, in
    closed form."""
    q = torch.sigmoid(phi)
    terms = []
    for z in (0, 1):
        zi = torch.tensor(float(z), device=phi.device)
        terms.append(dist.Bernoulli(0.3).log_prob(zi) + dist.Normal(mus[z], 1.0).log_prob(data)
                     - dist.Bernoulli(logits=phi).log_prob(zi))
    return -((1 - q) * terms[0] + q * terms[1])


def phase_guides(device, ecs_ms):
    """Phase 13's legs (b)-(d); returns their wall seconds."""
    t0 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    # (b) TraceGraph_ELBO
    particles, phi0 = TG_RUN
    mus = torch.tensor([-1.0, 1.0], device=device)
    data = torch.tensor(1.0, device=device)
    phi = torch.tensor(phi0, device=device)
    elbo = TraceGraph_ELBO(num_particles=particles)

    def loss(phi):
        gen = torch.Generator(device=device).manual_seed(0)
        return elbo.loss(gen, {}, tg_model, lambda m, d: npt.sample(
            "z", dist.Bernoulli(logits=phi)), mus, data)

    t = time.perf_counter()
    got = torch.func.grad(loss)(phi).item()
    wall_b = time.perf_counter() - t
    want = torch.func.grad(tg_exact_loss)(phi, mus, data).item()
    log(f"[guides] 13b TraceGraph_ELBO, {particles} particles, one loss and gradient: "
        f"{wall_b:.2f} s; gradient {got:.4f} against the closed form {want:.4f} (gate {TG_GATE})")
    if not abs(got - want) < TG_GATE:
        raise SystemExit(f"13b: the surrogate's gradient {got} is off {want}")

    # (c) AutoLowRankMultivariateNormal
    y = torch.tensor(ES_Y, device=device)
    sigma = torch.tensor(ES_SIGMA, device=device)
    model_nc = handlers.reparam(eight_schools, config={"theta": LocScaleReparam(0)})
    lr, steps, _ = ES_SVI
    guide = autoguide.AutoLowRankMultivariateNormal(model_nc)
    t = time.perf_counter()
    res = SVI(model_nc, guide, Adam(lr), Trace_ELBO()).run(14, steps, y, sigma)
    losses = res.losses.cpu()
    wall_c = time.perf_counter() - t
    med = guide.median(res.params)
    gaps = {k: abs(med[k].item() - EIGHT_SCHOOLS_REF[k]["mean"]) for k in ("mu", "tau")}
    log(f"[guides] 13c AutoLowRankMultivariateNormal (rank "
        f"{res.params['auto_cov_factor'].shape[1]}), {steps} steps: {wall_c:.2f} s, "
        f"{wall_c / steps * 1e3:.2f} ms per step; loss of the first 50 "
        f"{losses[:50].mean().item():.2f}, of the last 50 {losses[-50:].mean().item():.2f}; "
        f"medians mu {med['mu'].item():.3f}, tau {med['tau'].item():.3f}; gaps to "
        f"EIGHT_SCHOOLS_REF {[round(gaps[k], 4) for k in gaps]} (gates "
        f"{[LOWRANK_GATE[k] for k in gaps]})")
    if not torch.isfinite(losses).all() or not all(gaps[k] < LOWRANK_GATE[k] for k in gaps):
        raise SystemExit(f"13c: the low-rank guide's medians are off: {gaps}")

    # (d) AutoLaplaceApproximation with Minimize
    start = {k: torch.full((8,) if k == "theta_decentered" else (), v, device=device)
             for k, v in LAPLACE_START.items()}
    guide = autoguide.AutoLaplaceApproximation(model_nc, init_loc_fn=init_to_value(values=start))
    t = time.perf_counter()
    res = SVI(model_nc, guide, Minimize(), Trace_ELBO()).run(15, 1, y, sigma)
    posterior = guide.get_posterior(res.params)
    std = posterior.covariance_matrix.diagonal().sqrt()
    wall_d = time.perf_counter() - t
    loc = res.params["auto_loc"].cpu().numpy()
    map_gap = float(np.abs(loc - np.asarray(LAPLACE_MAP)).max())
    std_gap = float(np.abs(std.cpu().numpy() - np.asarray(LAPLACE_STD)).max())
    log(f"[guides] 13d AutoLaplaceApproximation, Minimize (BFGS): {wall_d:.2f} s; loss "
        f"{res.losses[0].item():.4f}; MAP {np.round(loc.astype(np.float64), 4).tolist()}, largest gap to JAX's "
        f"{map_gap:.5f}; stds {np.round(std.cpu().numpy().astype(np.float64), 4).tolist()}, largest gap "
        f"{std_gap:.5f} (gate {LAPLACE_GATE})")
    if not (map_gap < LAPLACE_GATE and std_gap < LAPLACE_GATE):
        raise SystemExit("13d: the Laplace approximation is off the JAX package's")
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("13b-d: a guide leg launched a GLM kernel")
    wall = time.perf_counter() - t0
    log(f"[guides] 13b-d: {wall:.1f} s, about {wall * 24.0 / ecs_ms:.1f} s on a host where the "
        f"ECS leg takes 24.0 ms per evaluation")
    return wall


def run_svi(tag, model_fn, guide, loss, steps, *args):
    """``SVI.init`` and ``steps`` updates on the default device, with every
    launch count set to 0 just before; returns the result, the launches of
    init and of the steps, and the host's ms per step."""
    svi = SVI(model_fn, guide, Adam(0.01), loss)
    glm.reset_launch_counts()
    state = svi.init(8, *args)
    torch.cuda.synchronize()
    init_launches = dict(glm.launch_counts)
    t0 = time.perf_counter()
    res = svi.run(None, steps, *args, init_state=state)
    losses = res.losses.cpu()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k: v - init_launches[k] for k, v in glm.launch_counts.items()}
    if res.losses.device.type != svi.device.type:
        raise SystemExit(f"{tag}: the losses are on {res.losses.device}, not on the run's device")
    bad = (~torch.isfinite(losses)).nonzero().flatten()
    if len(bad):
        raise SystemExit(f"{tag}: {len(bad)} of {steps} losses are not finite, the first at step "
                         f"{bad[0].item()} ({losses[bad[0]].item()}; the step before "
                         f"{losses[bad[0] - 1].item() if bad[0] else 'none'})")
    log(f"[svi] {tag}: {steps} steps, {ms:.2f} ms per step on the host's clock; loss mean of "
        f"the first 100 {losses[:100].mean().item():.2f}, of the last 100 "
        f"{losses[-100:].mean().item():.2f}; launches at init {init_launches}, in the "
        f"steps {launches}")
    return svi, res, losses, init_launches, launches, ms


def phase_svi_covtype(X, y, true_w, leg, posterior):
    """8a-8c: one guide on the covtype model in split mode; returns the SVI
    object, its result, the leg's launches and its ms per step."""
    name, particles, steps, init_traces = SVI_LEGS[leg]
    data = glm.prepare_glm_data(X, y, dtype="split")
    guide = getattr(autoguide, name)(model)
    svi, res, losses, init_l, step_l, ms = run_svi(
        f"{leg} {name}, {particles} particle(s)", model, guide,
        Trace_ELBO(num_particles=particles), steps, data)
    loc = guide.median(res.params)["w"]
    err = (loc.cpu() - torch.from_numpy(true_w)).abs().max().item()
    off_mean = (loc.double().cpu() - posterior["mean"].cpu()).abs().max().item()
    log(f"[svi] {leg}: max |loc - true_w| {err:.4f} (gate {SVI_GATE}); max |loc - phase 4's "
        f"posterior mean| {off_mean:.4f}")
    if init_l["glm_split"] != init_traces or step_l["glm_split"] != steps or any(
            v for k, v in {**init_l, **step_l}.items() if k != "glm_split"):
        raise SystemExit(f"{leg}: launched {init_l} at init and {step_l} in {steps} steps, "
                         f"expected {init_traces} and {steps} glm_split launches")
    if not err < SVI_GATE:
        raise SystemExit(f"{leg}: the guide's location is off by {err:.4f} (>= {SVI_GATE})")
    if leg == "8b":
        if not losses[-100:].mean() < losses[:100].mean():
            raise SystemExit("8b: the loss did not fall")
        ratio = res.params["auto_scale"].double().cpu() / posterior["std"].cpu()
        log(f"[svi] 8b: guide scale / phase 4's posterior std: median "
            f"{ratio.median().item():.3f}, min {ratio.min().item():.3f}, max "
            f"{ratio.max().item():.3f}")
    if leg == "8c":
        L = res.params["auto_scale_tril"].double().cpu()
        cov, ref = L @ L.T, posterior["cov"].cpu()
        frob = (torch.linalg.norm(cov - ref) / torch.linalg.norm(ref)).item()
        log(f"[svi] 8c: guide covariance off phase 4's sample covariance by {frob:.4f} "
            f"(relative Frobenius)")
    return svi, res, data, step_l["glm_split"] + init_l["glm_split"], ms


def check_elbo_gradient(svi, res, data, particles=SVI_LEGS["8b"][1], tag="8b"):
    """One Trace_ELBO gradient at a fitted guide's params through
    ``glm_split`` and through the plain version, on the same draws (two
    generators from one seed); returns the gradient's max abs error."""
    u = svi.optim.get_params(res.state.optim_state)
    loss = Trace_ELBO(num_particles=particles)
    out = {}
    model_plain = functools.partial(model, loglik=glm.plain_bernoulli_logits_loglik)
    for version, model_fn in (("kernel", model), ("plain", model_plain)):
        def fn(unconstrained, model_fn=model_fn):
            gen = torch.Generator(device=data.device).manual_seed(21)
            return loss.loss(gen, svi.constrain_fn(unconstrained), model_fn, svi.guide, data)

        out[version] = torch.func.grad_and_value(fn)(u)
    torch.cuda.synchronize()
    (g_k, l_k), (g_p, l_p) = out["kernel"], out["plain"]
    ll_rtol, g_rtol, g_atol = glm.kernel_tolerances("split", N)
    l_rel = (abs(l_k - l_p) / abs(l_p)).item()
    # a guide's param may be a tree (a network's layers): compare its leaves
    pairs = {k: list(zip(tree_leaves(g_k[k]), tree_leaves(g_p[k]))) for k in g_k}
    errs = {k: max((a - b).abs().max().item() for a, b in v) for k, v in pairs.items()}
    need = max(((a - b).abs() - g_rtol * b.abs()).max().item()
               for v in pairs.values() for a, b in v)
    top = max(b.abs().max().item() for v in pairs.values() for _, b in v)
    log(f"[svi] ELBO gradient at {tag}'s params, glm_split against the plain version: loss "
        f"rel err {l_rel:.3e} (rtol {ll_rtol}); gradient max abs err {errs} on components up to "
        f"{top:.3e} (rtol {g_rtol}, atol {g_atol:.3e}; the least atol that passes: {need:.3e})")
    if not (l_rel <= ll_rtol and need <= g_atol):
        raise SystemExit("the ELBO gradient through glm_split disagrees with the plain version")
    return max(errs.values())


def phase_svi(X, y, true_w, posterior, kernels):
    """Phase 8; returns the glm_split launches of its legs and 8d's MAP."""
    launches, summary = 0, {}
    for leg in SVI_LEGS:
        svi, res, data, n, ms = phase_svi_covtype(X, y, true_w, leg, posterior)
        launches += n
        summary[leg] = ms
        if leg == "8b":
            g_err = check_elbo_gradient(svi, res, data)
            d_pad, n_pad = data.x_t.shape
            w = res.params["auto_loc"].reshape(1, D) + 0.01 * torch.randn(
                (16, D), device=X.device, generator=torch.Generator(X.device).manual_seed(4))
            for b in (1, 16):
                t = cuda_ms(lambda: glm.glm_value_and_grad(w[:b].contiguous(), data))
                bound, _ = bound_ms("split", b, d_pad, n_pad)
                log(f"[svi] glm_split at {b} chain(s): {t:.3f} ms (bound {bound:.4f} ms, "
                    f"share {bound / t:.3f})")
                kernels["glm_split"][f"ms_at_{b}_chains"] = t
            kernels["glm_split"]["svi_elbo_grad_max_abs_err"] = g_err
        del data

    steps, gate = SVI_ECS
    guide = autoguide.AutoDelta(model_ecs)
    _, res, _, init_l, step_l, ms = run_svi("8d AutoDelta, subsampled model", model_ecs, guide,
                                             Trace_ELBO(), steps, X, y)
    summary["8d"] = ms
    w_map = guide.median(res.params)["w"].cpu().numpy()
    err = np.abs(w_map - true_w).max()
    log(f"[svi] 8d: max |MAP - true_w| {err:.4f} (gate {gate})")
    if any(init_l.values()) or any(step_l.values()):
        raise SystemExit("8d: the subsampled model launched a GLM kernel")
    if not err < gate:
        raise SystemExit(f"8d: MAP off by {err:.4f} (>= {gate})")

    particles, steps = HS_SVI
    Xh, yh, beta_true = horseshoe_data(X.device)
    guide = autoguide.AutoNormal(model_horseshoe)
    _, res, losses, _, _, ms = run_svi(
        f"8e horseshoe, AutoNormal, TraceMeanField_ELBO({particles})", model_horseshoe, guide,
        TraceMeanField_ELBO(num_particles=particles), steps, Xh, yh)
    summary["8e"] = ms
    med = guide.median(res.params)
    err = np.abs(med["beta"].double().cpu().numpy() - beta_true).max()
    log(f"[svi] 8e: max |median(beta) - beta_true| {err:.4f} (gate {HS_SVI_GATE}); median "
        f"tau {med['tau'].item():.4f}, sigma {med['sigma'].item():.4f}")
    if not err < HS_SVI_GATE:
        raise SystemExit(f"8e: median of beta off by {err:.4f} (>= {HS_SVI_GATE})")
    log(f"[svi] ms per step: {summary}")
    return launches, w_map


def phase_iaf(X, y, true_w):
    """14a: AutoIAFNormal on the covtype model in split mode; returns the
    guide, its result, the data, the leg's glm_split launches and ms per
    step."""
    particles, steps = IAF_RUN
    data = glm.prepare_glm_data(X, y, dtype="split")
    guide = autoguide.AutoIAFNormal(model, num_flows=3, hidden_dims=[D, D])
    svi, res, losses, init_l, step_l, ms = run_svi(
        f"14a AutoIAFNormal (3 flows, hidden [{D}, {D}], ELU), {particles} particles", model,
        guide, Trace_ELBO(num_particles=particles), steps, data)
    t0 = time.perf_counter()
    draws = guide.sample_posterior(torch.Generator(device=X.device).manual_seed(14),
                                   res.params, sample_shape=(IAF_DRAWS,))["w"]
    draw_s = time.perf_counter() - t0
    if draws.shape != (IAF_DRAWS, D) or not torch.isfinite(draws).all():
        raise SystemExit(f"14a: bad draws, shape {tuple(draws.shape)}")
    err = (draws.mean(0).cpu() - torch.from_numpy(true_w)).abs().max().item()
    std = draws.double().std(0)
    log(f"[flows] 14a: {IAF_DRAWS} draws of sample_posterior in {draw_s:.2f} s; max |mean(w) - "
        f"true_w| {err:.4f} (gate {IAF_GATE}); draws' std median {std.median().item():.5f} "
        f"(min {std.min().item():.5f}, max {std.max().item():.5f}); loss of the first 50 "
        f"{losses[:50].mean().item():.2f}, of the last 50 {losses[-50:].mean().item():.2f}")
    if init_l["glm_split"] != IAF_INIT_TRACES or step_l["glm_split"] != steps or any(
            v for k, v in {**init_l, **step_l}.items() if k != "glm_split"):
        raise SystemExit(f"14a: launched {init_l} at init and {step_l} in {steps} steps, "
                         f"expected {IAF_INIT_TRACES} and {steps} glm_split launches")
    if not err < IAF_GATE:
        raise SystemExit(f"14a: the guide's posterior mean is off by {err:.4f} (>= {IAF_GATE})")
    check_elbo_gradient(svi, res, data, particles, "14a")
    return guide, res, data, init_l["glm_split"] + step_l["glm_split"], ms


def phase_neutra(X, y, true_w, guide, params, data, nuts):
    """14b: NUTS on the covtype model reparameterised through 14a's flow;
    returns its glm_split launches (``nuts``: phase 4's split-mode stats)."""
    chains, warmup, samples, depth, gate = NEUTRA_RUN
    neutra = NeuTraReparam(guide, params)
    neutra_model = neutra.reparam(model)
    mcmc = MCMC(NUTS(neutra_model, max_tree_depth=depth), num_warmup=warmup,
                num_samples=samples, num_chains=chains)
    before = dict(glm.launch_counts)
    mcmc.run(torch.Generator(device=X.device).manual_seed(14), data)
    launches = {k: v - before[k] for k, v in glm.launch_counts.items()}
    stats = mcmc.last_run_stats
    got = mcmc.get_samples(group_by_chain=True)
    z = got["w_shared_latent"]
    w = neutra.transform_sample(z)["w"]
    if w.shape != (chains, samples, D) or not torch.isfinite(w).all():
        raise SystemExit(f"14b: bad draws, shape {tuple(w.shape)}")
    if not torch.allclose(w, got["w"], rtol=1e-5, atol=1e-6):
        raise SystemExit("14b: transform_sample disagrees with the run's deterministic w")
    err = (w.mean((0, 1)).cpu() - torch.from_numpy(true_w)).abs().max().item()
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    wall = stats["warmup_s"] + stats["sample_s"]
    per_draw = stats["potential_evals_sample"] / samples
    # the deterministic site w is replayed after the run, one vmap (and one
    # launch) per chunk of draws
    replays = math.ceil(chains * samples / POSTPROCESS_CHUNK)
    nuts_per_draw = nuts["potential_evals_sample"] / RUNS["glm_split"][1]
    log(f"[flows] 14b NUTS on NeuTraReparam(14a), covtype split mode, {chains} chains, "
        f"{warmup} + {samples}, depths {depth}: init {stats['init_s']:.2f} s, warmup "
        f"{stats['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} s; evaluations "
        f"{stats['potential_evals_warmup']} + {stats['potential_evals_sample']} + "
        f"{stats['init_traces']} init trace(s) + {replays} replay(s) of the draws; glm_split "
        f"launches {launches['glm_split']}; "
        f"{wall / evals * 1e3:.2f} ms per evaluation against phase 4's "
        f"{nuts['ms_per_eval']:.2f}; {per_draw:.1f} evaluations a sampling transition against "
        f"phase 4's {nuts_per_draw:.1f}; max |mean(w) - true_w| {err:.4f} (gate {gate})")
    if launches["glm_split"] != stats["potential_evals"] + stats["init_traces"] + replays or any(
            v for k, v in launches.items() if k != "glm_split"):
        raise SystemExit(f"14b: launched {launches} for {stats['potential_evals']} evaluations, "
                         f"{stats['init_traces']} init trace(s) and {replays} replay(s)")
    if not err < gate:
        raise SystemExit(f"14b: posterior means off by {err:.4f} (>= {gate})")

    # the potential and its gradient at the last draws of all chains,
    # through glm_split and through the plain version (not counted)
    layout = FlatLayout({"w_shared_latent": z[0, 0]})
    panel = z[:, -1].contiguous()
    out = {}
    plain_model = neutra.reparam(functools.partial(model, loglik=glm.plain_bernoulli_logits_loglik))
    for tag, fn in (("kernel", neutra_model), ("plain", plain_model)):
        pe_fn, _ = infer_util.get_potential_fn(fn, {}, model_args=(data,))
        out[tag] = batched_potential(pe_fn, layout)(panel)
    torch.cuda.synchronize()
    (pe_k, g_k), (pe_p, g_p) = out["kernel"], out["plain"]
    ll_rtol, g_rtol, g_atol = glm.kernel_tolerances("split", N)
    pe_rel = ((pe_k - pe_p).abs() / pe_p.abs()).max().item()
    need = ((g_k - g_p).abs() - g_rtol * g_p.abs()).max().item()
    log(f"[flows] 14b potential at {chains} chains through glm_split against the plain "
        f"version: max rel err {pe_rel:.3e} (rtol {ll_rtol}); gradient max abs err "
        f"{(g_k - g_p).abs().max().item():.3e} on components up to "
        f"{g_p.abs().max().item():.3e} (rtol {g_rtol}, atol {g_atol:.3e}; the least atol that "
        f"passes: {need:.3e})")
    if not (pe_rel <= ll_rtol and need <= g_atol):
        raise SystemExit("14b: the NeuTra potential through glm_split disagrees with the plain "
                         "version")
    return launches["glm_split"]


def dual_moon(zeros):
    """``examples/neutra.py``'s model: two half-moons at x0 = +-2."""
    x = npt.sample("x", dist.Normal(zeros, 10.0).to_event(1))
    term1 = 0.5 * ((torch.linalg.vector_norm(x, dim=-1) - 2) / 0.4) ** 2
    # the example's log(sum over the shifts -2 and 2 of exp(term2))
    left, right = (-0.5 * ((x[..., 0] + shift) / 0.6) ** 2 for shift in (-2.0, 2.0))
    npt.factor("dual_moon", -(term1 - torch.log(torch.exp(left) + torch.exp(right))))


def dais_demo_data(n, device):
    """``examples/dais_demo.py``'s strongly correlated design, numpy seed 0."""
    rng = np.random.RandomState(0)
    base = rng.randn(n, 1)
    X = np.concatenate([base + 0.1 * rng.randn(n, 1), base + 0.1 * rng.randn(n, 1)], 1)
    y = (rng.rand(n) < 0.5).astype(np.float32)
    return (torch.tensor(X, dtype=torch.float32, device=device),
            torch.tensor(y, device=device))


def dais_demo_model(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(X.shape[1], device=X.device), 1.0).to_event(1))
    with npt.plate("N", X.shape[0]):
        npt.sample("y", dist.Bernoulli(logits=X @ w), obs=y)


def sum_model(y):
    """``tests/infer/test_autoguide_extra.py``'s model: the posterior mean
    of x0 + x1 given y = 2 is 16 / 9."""
    x = npt.sample("x", dist.Normal(torch.zeros(2, device=y.device), 1.0).to_event(1))
    npt.sample("y", dist.Normal(x.sum(), 0.5), obs=y)


def sum_surrogate(y):
    """A surrogate likelihood of ``sum_model`` with a learned scale."""
    def surrogate():
        x = npt.sample("x", dist.Normal(torch.zeros(2, device=y.device), 1.0).to_event(1))
        s = npt.param("surrogate_scale", torch.tensor(0.7, device=y.device),
                      constraint=dist.constraints.positive)
        npt.sample("y", dist.Normal(x.sum(), s), obs=y)

    return surrogate


def batched_model(y):
    with npt.plate("B", 3):
        x = npt.sample("x", dist.Normal(torch.zeros(2, device=y.device), 1.0).to_event(1))
        npt.sample("y", dist.Normal(x.sum(-1), 0.5), obs=y)


def phase_flow_examples(device):
    """14c-e: the dual moon through a BNAF flow, the DAIS demo, and the
    surrogate DAIS and batched guides; returns their wall seconds."""
    t0 = time.perf_counter()
    launches0 = dict(glm.launch_counts)
    # (c) the dual moon
    steps, lr, chains, warmup, samples, depth, on_ring = DUAL_MOON
    zeros = torch.zeros(2, device=device)
    guide = autoguide.AutoBNAFNormal(dual_moon, hidden_factors=[8, 8])
    t = time.perf_counter()
    res = SVI(dual_moon, guide, Adam(lr), Trace_ELBO()).run(141, steps, zeros)
    losses = res.losses.cpu()
    svi_s = time.perf_counter() - t
    neutra = NeuTraReparam(guide, res.params)
    mcmc = MCMC(NUTS(neutra.reparam(dual_moon), max_tree_depth=depth), num_warmup=warmup,
                num_samples=samples, num_chains=chains)
    mcmc.run(142, zeros)
    stats = mcmc.last_run_stats
    x = neutra.transform_sample(mcmc.get_samples()["x_shared_latent"])["x"]
    share = (x[:, 0] > 0).double().mean().item()
    ring = ((torch.linalg.vector_norm(x, dim=-1) - 2).abs() < 3 * 0.4).double().mean().item()
    wall_c = time.perf_counter() - t
    evals = stats["potential_evals_warmup"] + stats["potential_evals_sample"]
    log(f"[flows] 14c dual moon: AutoBNAFNormal {steps} steps in {svi_s:.2f} s "
        f"({svi_s / steps * 1e3:.2f} ms a step), loss {losses[:20].mean().item():.2f} -> "
        f"{losses[-20:].mean().item():.2f}; NUTS on the NeuTra model, {chains} chains, {warmup} + "
        f"{samples}, depths {depth}: {stats['warmup_s'] + stats['sample_s']:.2f} s, {evals} "
        f"evaluations ({(stats['warmup_s'] + stats['sample_s']) / evals * 1e3:.2f} ms each); "
        f"share of draws with x0 > 0: {share:.3f} (not gated); share on the ring {ring:.3f} "
        f"(gate {on_ring}); {wall_c:.2f} s")
    if not (torch.isfinite(x).all() and ring >= on_ring
            and losses[-20:].mean() < losses[:20].mean()):
        raise SystemExit(f"14c: {ring:.3f} of the draws on the moons' ring (< {on_ring}) or the "
                         "loss did not fall")

    # (d) the DAIS demo
    n, steps, lr, particles, draws = DAIS_DEMO
    X, y = dais_demo_data(n, device)
    start = init_to_value(values={"w": torch.zeros(2, device=device)})
    t = time.perf_counter()
    gaps = {}
    for name, guide in (
            ("mean-field", autoguide.AutoDiagonalNormal(dais_demo_model, init_loc_fn=start)),
            ("AutoDAIS", autoguide.AutoDAIS(dais_demo_model, K=4, eta_init=0.01,
                                            init_loc_fn=start))):
        ts = time.perf_counter()
        res = SVI(dais_demo_model, guide, Adam(lr), Trace_ELBO(num_particles=particles)).run(
            143, steps, X, y)
        w = guide.sample_posterior(torch.Generator(device=device).manual_seed(144), res.params,
                                   sample_shape=(draws,))["w"].double()
        if not torch.isfinite(w).all():
            raise SystemExit(f"14d: {name}'s draws are not finite")
        mean, sd = w.mean(0).cpu().numpy(), w.std(0).cpu().numpy()
        corr = torch.corrcoef(w.T)[0, 1].item()
        gaps[name] = (max(np.abs(mean - np.asarray(DAIS_GATE["mean"])).max(),
                          np.abs(sd - np.asarray(DAIS_GATE["sd"])).max()),
                      abs(corr - DAIS_GATE["corr"]))
        log(f"[flows] 14d {name}, {particles} particles: {steps} steps and {draws} draws in "
            f"{time.perf_counter() - ts:.2f} s; final loss {res.losses[-20:].mean().item():.2f}; "
            f"posterior mean {np.round(mean, 4).tolist()}, sd {np.round(sd, 4).tolist()}, "
            f"correlation {corr:.4f}; gaps to the JAX package's AutoDAIS: mean and sd "
            f"{gaps[name][0]:.4f} (gate {DAIS_GATE['gate']}), correlation {gaps[name][1]:.4f} "
            f"(gate {DAIS_GATE['corr_gate']})")
    wall_d = time.perf_counter() - t
    inside = {k: v[0] < DAIS_GATE["gate"] and v[1] < DAIS_GATE["corr_gate"]
              for k, v in gaps.items()}
    log(f"[flows] 14d within the gates: {inside}; {wall_d:.2f} s")
    if not inside["AutoDAIS"]:
        raise SystemExit(f"14d: AutoDAIS's posterior is off the JAX package's: {gaps}")
    if inside["mean-field"]:
        raise SystemExit("14d: the mean-field guide passes the DAIS gates, which then cannot "
                         "tell the annealing from a mean-field fit")

    # (e) the surrogate DAIS guide and the batched guides
    walls = {}
    y2 = torch.tensor(2.0, device=device)
    yb = torch.tensor([1.0, 2.0, -1.0], device=device)
    legs = {
        "surrogate": (sum_model, autoguide.AutoSurrogateLikelihoodDAIS(
            sum_model, sum_surrogate(y2), K=2), y2, 16 / 9),
        "batched_mvn": (batched_model, autoguide.AutoBatchedMultivariateNormal(
            batched_model, batch_ndim=1), yb, 2 * yb.cpu() / 2.25),
        "batched_lowrank": (batched_model, autoguide.AutoBatchedLowRankMultivariateNormal(
            batched_model, batch_ndim=1), yb, 2 * yb.cpu() / 2.25),
    }
    for leg, (model_fn, guide, obs, want) in legs.items():
        steps, lr, particles = SMALL_GUIDES[leg]
        if lr == "decay":
            lr = lambda i: 0.1 / (1 + i / 20)  # noqa: E731
        ts = time.perf_counter()
        res = SVI(model_fn, guide, Adam(lr), Trace_ELBO(num_particles=particles)).run(
            145, steps, obs)
        if leg == "surrogate":
            s = guide.sample_posterior(torch.Generator(device=device).manual_seed(146),
                                       res.params, sample_shape=(500,))
            got = s["x"].sum(-1).mean().cpu()
        else:
            got = guide.median(res.params)["x"].sum(-1).cpu()
        walls[leg] = time.perf_counter() - ts
        gap = (torch.as_tensor(got) - torch.as_tensor(want)).abs().max().item()
        scale = res.params["surrogate_scale"].item() if leg == "surrogate" else None
        extra = ("" if scale is None else
                 f"; surrogate scale {scale:.4f} (initial 0.7, no gradient)")
        log(f"[flows] 14e {leg}: {steps} steps in {walls[leg]:.2f} s; x0 + x1 "
            f"{np.round(np.atleast_1d(got.numpy()), 4).tolist()} against "
            f"{np.round(np.atleast_1d(np.asarray(want)), 4).tolist()}, gap {gap:.4f} (gate "
            f"{SMALL_GATE}){extra}")
        if not (torch.isfinite(res.losses).all() and gap < SMALL_GATE):
            raise SystemExit(f"14e: {leg} is off by {gap:.4f}")
        if scale is not None and abs(scale - 0.7) > 1e-6:
            raise SystemExit(f"14e: the surrogate's param moved to {scale:.4f}; like the JAX "
                             "package's it gets no gradient")
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("14c-e: a leg launched a GLM kernel")
    return time.perf_counter() - t0

# phase 22.  (a) transitions sampled from phase 4's per-step leg's
# post_warmup_state restored from a checkpoint on disk, which must equal the
# leg's own first transitions (resumed from the state in memory) bit for bit
RESUME_TRANSITIONS = 3
# (b) examples/vae.py at its widths (784 -> 64 -> 16, batch 64 of the MNIST
# surrogate, Adam(1e-3)): steps (cut from the example's 300 to the phase's
# budget); the ELBO on the card against the CPU's at the same weights and
# draws, rtol VAE_RTOL
VAE_HIDDEN, VAE_Z, VAE_BATCH = 64, 16, 64
VAE_STEPS = 100
VAE_RTOL = 1e-4
# (c) examples/minipyro.py through compat: steps (cut from the example's 400
# to the fewest that hold its gate, |loc_hat - mean(data)| < 0.1, on the CPU)
# and the rtol of the card's trajectory of loc_q against the CPU's
MINIPYRO_STEPS = 60
MINIPYRO_GATE = 0.1
MINIPYRO_RTOL = 1e-5


class VaeEncoder(torch.nn.Module):
    """``examples/vae.py``'s encoder: a softplus hidden layer, then the
    location and the scale (the exponential of a linear layer)."""

    def __init__(self, out=784, hidden=VAE_HIDDEN, z_dim=VAE_Z):
        super().__init__()
        self.hidden = torch.nn.Sequential(torch.nn.Linear(out, hidden), torch.nn.Softplus())
        self.loc = torch.nn.Linear(hidden, z_dim)
        self.scale = torch.nn.Linear(hidden, z_dim)

    def forward(self, x):
        h = self.hidden(x)
        return self.loc(h), torch.exp(self.scale(h))


def vae_networks(device, out=784, hidden=VAE_HIDDEN, z_dim=VAE_Z, seed=0):
    """The example's encoder and decoder (``nn.Linear`` layers in the order
    of the flax modules' ``Dense_i``), built on the CPU from ``seed``
    (torch's initializers draw from its global generator, forked here) and
    moved to ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        encoder = VaeEncoder(out, hidden, z_dim)
        decoder = torch.nn.Sequential(torch.nn.Linear(z_dim, hidden), torch.nn.Softplus(),
                                      torch.nn.Linear(hidden, out), torch.nn.Sigmoid())
    return encoder.to(device), decoder.to(device)


def vae_model(batch, encoder, decoder):
    """``examples/vae.py``'s model: ``z ~ N(0, 1)`` per image, the decoder's
    pixel probabilities clipped to [1e-6, 1 - 1e-6]."""
    net = torch_module("decoder", decoder)
    z_dim = decoder[0].in_features
    with npt.plate("batch", batch.shape[0]):
        z = npt.sample("z", dist.Normal(torch.zeros(z_dim, device=batch.device),
                                        torch.ones(z_dim, device=batch.device)).to_event(1))
        probs = net(z).clamp(1e-6, 1 - 1e-6)
        npt.sample("obs", dist.Bernoulli(probs).to_event(1), obs=batch)


def vae_guide(batch, encoder, decoder):
    """``examples/vae.py``'s guide: ``z ~ N(loc, scale)`` from the encoder."""
    net = torch_module("encoder", encoder)
    with npt.plate("batch", batch.shape[0]):
        loc, scale = net(batch)
        npt.sample("z", dist.Normal(loc, scale).to_event(1))


def vae_batches(batch_size=VAE_BATCH):
    """``examples/vae.py``'s batches: the MNIST training split in order (the
    JAX package's surrogate where the files are not in ``DATA_DIR``), the
    pixels binarized at 0.5; returns the number of batches and a function
    of the step."""
    init, get_batch = load_dataset(MNIST, batch_size=batch_size, split="train", shuffle=False)
    num_batches, idxs = init()
    return num_batches, lambda i: (get_batch(i % num_batches, idxs)[0] > 0.5).astype(np.float32)


def minipyro_data():
    """``examples/minipyro.py``'s data: 100 draws of N(2, 0.5^2) from numpy's
    RandomState(0)."""
    return 2.0 + 0.5 * np.random.RandomState(0).randn(100)


def minipyro_model(data):
    loc = compat_pyro.sample("loc", compat_dist.Normal(0.0, 1.0))
    with compat_pyro.plate("N", data.shape[0]):
        compat_pyro.sample("obs", compat_dist.Normal(loc, 1.0), obs=data)


def minipyro_guide(data):
    loc_q = compat_pyro.param("loc_q", torch.zeros((), device=data.device))
    compat_pyro.sample("loc", compat_dist.Delta(loc_q))


def minipyro_trajectory(device, steps=MINIPYRO_STEPS):
    """``examples/minipyro.py``'s SVI through ``compat`` on ``device``: the
    loss and ``loc_q`` after each step, and the data."""
    data = compat_ops.tensor(minipyro_data(), device=device)
    svi = compat_infer.SVI(minipyro_model, minipyro_guide, compat_optim.Adam({"lr": 0.05}),
                           compat_infer.Trace_ELBO(), device=device)
    locs, losses = [], []
    for i in range(steps):
        losses.append(svi.step(data, rng_key=0 if i == 0 else None))
        locs.append(svi.get_params()["loc_q"])
    return torch.stack(losses), torch.stack(locs), data


def phase_resume(resume):
    """22a: the per-step leg's post_warmup_state from the checkpoint on disk
    onto the card, then RESUME_TRANSITIONS transitions, which must equal the
    leg's first ones bit for bit; returns the glm_split launches and the
    wall seconds."""
    t0 = time.perf_counter()
    chains, warmup = PER_STEP[:2]
    target = resume["target"]
    state = restore_checkpoint(resume["path"], target)
    leaves, restored = tree_leaves(target), tree_leaves(state)
    if not (len(leaves) == len(restored)
            and all(a.device == b.device and torch.equal(a, b) for a, b in zip(leaves, restored))
            and state.rng_key.device == target.rng_key.device
            and torch.equal(state.rng_key.get_state(), resume["rng_state"])):
        raise SystemExit("22a: the restored state differs from the saved one")
    # the leg's kernel, initialized there (a kernel state resumes on the
    # kernel that made it, as in the JAX package)
    mcmc = MCMC(resume["kernel"], num_warmup=warmup, num_samples=RESUME_TRANSITIONS,
                num_chains=chains)
    mcmc.post_warmup_state = state
    before = glm.launch_counts["glm_split"]
    mcmc.run(2, resume["data"], extra_fields=("potential_energy",))
    launches = glm.launch_counts["glm_split"] - before
    evals = mcmc.last_run_stats["potential_evals"]
    draws = mcmc.get_samples(group_by_chain=True)["w"]
    pe = mcmc.get_extra_fields(group_by_chain=True)["potential_energy"]
    want_draws = resume["draws"][:, :RESUME_TRANSITIONS]
    want_pe = resume["pe"][:, :RESUME_TRANSITIONS]
    same = torch.equal(draws, want_draws) and torch.equal(pe, want_pe)
    gap = (draws - want_draws).abs().max().item()
    wall = time.perf_counter() - t0
    log(f"[resume] 22a: {chains} chains, {RESUME_TRANSITIONS} transitions from the "
        f"checkpoint ({state.rng_key.device} generator restored): {evals} potential "
        f"evaluations, glm_split launches {launches}, {wall:.2f} s; equal to the in-memory "
        f"resume bit for bit: {same} (largest gap of a draw {gap:.3e})")
    if launches != evals or evals == 0:
        raise SystemExit(f"22a launched glm_split {launches} times for {evals} evaluations")
    if not same:
        raise SystemExit("22a: the run resumed from the checkpoint differs from the one resumed "
                         "in memory")
    return launches, wall


def phase_vae(device):
    """22b: examples/vae.py through torch_module; returns its wall seconds,
    ms per step and host syncs of a step."""
    t0 = time.perf_counter()
    num_batches, batch_of = vae_batches()
    encoder, decoder = vae_networks(device)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    svi = SVI(vae_model, vae_guide, Adam(1e-3), Trace_ELBO())
    state = svi.init(221, to(batch_of(0)), encoder, decoder)
    losses = []
    for i in range(VAE_STEPS):
        state, loss = svi.update(state, to(batch_of(i)), encoder, decoder)
        losses.append(loss)
    losses = torch.stack(losses).cpu()
    wall_run = time.perf_counter() - t0
    batch = to(batch_of(VAE_STEPS))
    _, sites = count_syncs(lambda: svi.update(state, batch, encoder, decoder))
    # the ELBO at the same weights and draws on the card and on the CPU
    params = svi.get_params(state)
    eps = np.random.default_rng(222).standard_normal((VAE_BATCH, VAE_Z)).astype(np.float32)
    elbo = {}
    for where in (device, torch.device("cpu")):
        moved = {k: {n: v.to(where) for n, v in p.items()} for k, p in params.items()}
        draws = TableDraws([torch.from_numpy(eps).to(where)])
        elbo[where.type] = Trace_ELBO().loss(draws, moved, vae_model, vae_guide,
                                             batch.to(where), encoder, decoder).item()
    err = abs(elbo[device.type] - elbo["cpu"]) / abs(elbo["cpu"])
    syncs = sum(sites.values())
    ms = wall_run / VAE_STEPS * 1e3
    first, last = losses[0].item(), losses[-10:].mean().item()
    log(f"[vae] 22b vae.py, batch {VAE_BATCH} of {num_batches}, {VAE_STEPS} steps of "
        f"Adam(1e-3): {wall_run:.2f} s, {ms:.2f} ms per step (init included); ELBO loss "
        f"{first:.1f} -> {last:.1f} (mean of the last 10); {syncs} host syncs in a step "
        f"{sites}; the loss at the same weights and draws {elbo[device.type]:.4f} on the card, "
        f"{elbo['cpu']:.4f} on the CPU (rel err {err:.2e}, rtol {VAE_RTOL})")
    if not (torch.isfinite(losses).all() and last < first):
        raise SystemExit(f"22b: the loss does not fall or is not finite ({first} -> {last})")
    if not err <= VAE_RTOL:
        raise SystemExit(f"22b: the ELBO on the card is off the CPU's by {err:.2e}")
    return time.perf_counter() - t0, ms, syncs


def phase_minipyro(device):
    """22c: examples/minipyro.py through compat on the card and on the CPU;
    returns its wall seconds and ms per step on the card."""
    t0 = time.perf_counter()
    losses, locs, data = minipyro_trajectory(device)
    wall_card = time.perf_counter() - t0
    _, cpu_locs, _ = minipyro_trajectory(torch.device("cpu"))
    locs = locs.cpu()
    loc_hat, mean = locs[-1].item(), data.mean().item()
    err = ((locs - cpu_locs).abs() / cpu_locs.abs().clamp(min=1e-30)).max().item()
    ms = wall_card / MINIPYRO_STEPS * 1e3
    log(f"[compat] 22c minipyro.py, {MINIPYRO_STEPS} steps on {losses.device}: "
        f"{wall_card:.2f} s, {ms:.2f} ms per step; loc_hat {loc_hat:.4f} against the data's mean "
        f"{mean:.4f} (gate {MINIPYRO_GATE}); the trajectory of loc_q against the CPU's: largest "
        f"rel err {err:.2e} (rtol {MINIPYRO_RTOL})")
    if losses.device.type != device.type:
        raise SystemExit(f"22c: compat's SVI ran on {losses.device}, not on the card")
    if not (torch.isfinite(losses).all() and abs(loc_hat - mean) < MINIPYRO_GATE):
        raise SystemExit(f"22c: loc_hat {loc_hat:.4f} is off the data's mean {mean:.4f}")
    if not err <= MINIPYRO_RTOL:
        raise SystemExit(f"22c: the card's trajectory is off the CPU's by {err:.2e}")
    return time.perf_counter() - t0, ms


def phase_twenty_two(device, resume):
    """Phase 22: a NUTS run resumed from a checkpoint, examples/vae.py
    through torch_module and examples/minipyro.py through compat; returns
    the walls of its legs, 22b's ms and host syncs per step, 22c's ms per
    step and 22a's glm_split launches."""
    launches, wall_a = phase_resume(resume)
    launches0 = dict(glm.launch_counts)
    wall_b, ms_b, syncs_b = phase_vae(device)
    wall_c, ms_c = phase_minipyro(device)
    if launches0 != dict(glm.launch_counts):
        raise SystemExit("22b-c: launched a GLM kernel")
    walls = {"22a": wall_a, "22b": wall_b, "22c": wall_c}
    return walls, {"22b": ms_b, "22c": ms_c}, syncs_b, launches


# phase 23: chains and data across ranks, two ranks sharing the one card over
# gloo (NCCL refuses two ranks on one device), spawned from this script.
# (a) phase 4's per-step leg (PER_STEP: 64 chains, 10 + 5, warmup then a run
# from post_warmup_state) with its chains sharded 2 x 32: the gathered draws
# and potential energies against the leg's own; (b) a 1 x 2 data mesh: each
# rank's glm_split on its half of the rows plus one all_reduce, at phase 3's
# w_chains, against the one-process glm_split on the whole X, then pooled
# NUTS on the data-sharded model (chains, warmup, samples, tree depth), then
# the fused kernel's modes on the shard; (c) HMCECS on the data mesh; (d)
# ChEES with its chains sharded
RANKS = 2
DATA_NUTS = (64, 5, 5, 4)
SHARD_CHAINS = (32, 256)  # chains at which each kernel is timed on one data shard
# (b) the fused kernel's modes on the shard, beside glm_split
SHARD_MODES = {"glm_fused_f32": torch.float32, "glm_fused_bf16": torch.bfloat16}
# (c) HMCECS with the Taylor proxy at phase 8d's MAP, its chains started
# there, on the 1 x 2 data mesh and in one process on the whole X (the
# bench's subsample and blocks): chains, warmup, samples, tree depth, the
# ECS modes' gate.  Its length comes from a CPU rehearsal (``python3 -m
# dev.phase23 cpu``), to fit phase 23's budget
DATA_ECS = (32, 4, 4, 3, 0.2)
# the first evaluation's potential and gradient, data-sharded against one
# process: the proxy's whole-data sums add the two shards' float32 sums of
# 290,506 terms where one process sums all 581,012 in one reduction, so they
# differ by the rounding of a float32 sum (the CPU tests: 1.3e-7 relative on
# 64 rows).  The potential is held to DATA_ECS_RTOL of itself (its terms
# share one sign), each gradient component to DATA_ECS_RTOL of the sum of
# its terms' magnitudes, sum_n |x_nj (y_n - sigmoid(x_n . w))| at the MAP,
# since at the MAP the terms cancel to about 0 (about 2^7 float32 epsilons
# of rounding, of which a pairwise float32 sum of 2^20 terms spends 20)
DATA_ECS_RTOL = 1e-5
# (d) ChEES at CHEES_RUN's step size, trajectory and step cap, its chains
# sharded 2 x 32 on a chain mesh: chains, warmup, samples; held bit for bit
# against the same leg in one process
SHARDED_CHEES = (64, 4, 2)
# (e) pooled NUTS on model_rows over the 1 x 2 data mesh, started at phase
# 8d's MAP: chains, warmup, samples, tree depth, and the gate on max
# |mean(w) - true_w| (the bench's 0.05)
ROWS_NUTS = (32, 4, 4, 3, 0.05)
# (g) covtype with a latent a row (overdispersed logistic regression, Gelman
# & Hill 2007, ch. 15): w, tau ~ HalfNormal(1), e ~ Normal(0, 1) for each of
# the 581,012 rows under a plate of the whole data, y ~ Bernoulli(logits=X @
# w + tau * e) over shard_data's rows, e whole on every rank and cut to its
# rows.  (i) one evaluation at ROW_LATENT_RUN's chains with a logsumexp over
# the rows of the logits of X scaled by its columns' largest magnitudes
# (weighted LSE_WEIGHT) against a plain version summed by explicit
# all_reduces; (ii) pooled NUTS from phase 8d's MAP, tau at ROW_LATENT_TAU
# and e at 0: chains, warmup, samples, tree depth, 23e's gate; (iii)
# Predictive of ROW_LATENT_DRAWS draws of y against this script's on all rows
ROW_LATENT_RUN = (8, 2, 2, 3)
ROW_LATENT_TAU = 0.05
ROW_LATENT_DRAWS = 8
LSE_WEIGHT = 1e-3
RANK_TIMEOUT = 300  # seconds to warm up, and from the go to the end, before the script fails
SCRIPT_LIMIT = 1200  # seconds: a rank still waiting for the go by then ends itself
WARM_ROWS = 1000  # rows of the plain model a rank warms up on while the kernels build


def _rank_model_run(mcmc, data, step):
    """``mcmc``'s run on ``data`` (``step``: warmup then a resumed run, as
    phase 4's per-step leg; else one run) with the split kernel's launches
    counted from 0; returns the draws, the potential energies (or None), the
    launches, the evaluations and init traces, and the seconds."""
    name = "glm_split" if data.device.type == "cuda" else "plain"
    glm.reset_launch_counts()
    t0 = time.perf_counter()
    if step:
        mcmc.warmup(2, data)
        warm = dict(mcmc.last_run_stats)
        mcmc.run(2, data, extra_fields=("potential_energy",))
        evals = warm["potential_evals"] + mcmc.last_run_stats["potential_evals"] + 1
        pe = mcmc.get_extra_fields(group_by_chain=True)["potential_energy"].cpu()
        phases = {"init": warm["init_s"], "warmup": warm["warmup_s"],
                  "sampling": mcmc.last_run_stats["sample_s"]}
    else:
        mcmc.run(2, data)
        stats = mcmc.last_run_stats
        evals = stats["potential_evals"] + stats["init_traces"]
        pe = None
        phases = {k: stats[f"{k}_s"] for k in ("init", "warmup", "sample")}
    wall = time.perf_counter() - t0
    return {"draws": mcmc.get_samples(group_by_chain=True)["w"].cpu(), "pe": pe,
            "launches": glm.launch_counts[name], "evals": evals, "s": wall, "phases": phases}


def warm_model(x, y):
    """Logistic regression in plain PyTorch ops, no GLM kernel: a rank's
    first NUTS run before the kernels are built."""
    w = npt.sample("w", dist.Normal(torch.zeros(x.shape[1], device=x.device), 1.0).to_event(1))
    npt.sample("y", dist.Bernoulli(logits=x @ w), obs=y)


def model_rows(X, y, size):
    """The covtype model as a JAX user writes it over ``shard_data``'s rows:
    the likelihood in plain ops under a plate of the whole data's ``size``,
    no GLM op; the sums over the rows are the whole data's on every rank."""
    w = npt.sample("w", dist.Normal(torch.zeros(D, device=X.device), 1.0).to_event(1))
    with npt.plate("N", size):
        npt.sample("y", dist.Bernoulli(logits=X @ w), obs=y)


def model_rows_normal(X, y, size):
    """A model over ``shard_data``'s rows with several replicated latents
    that meet the rows: a Normal likelihood with a latent offset and scale
    (the linear-probability model of covtype's labels)."""
    zero, one = torch.zeros((), device=X.device), torch.ones((), device=X.device)
    w = npt.sample("w", dist.Normal(torch.zeros(D, device=X.device), 1.0).to_event(1))
    b = npt.sample("b", dist.Normal(zero, one))
    sigma = npt.sample("sigma", dist.HalfNormal(one))
    with npt.plate("N", size):
        npt.sample("y", dist.Normal(X @ w + b, sigma), obs=y)


def normal_rows_eval(X, y, w_chains, device):
    """23e's second model (``model_rows_normal``) on a rank's rows: one
    batched potential-and-gradient evaluation at ``w_chains``, warm, timed
    with its all_reduces over the data, and beside it the same evaluation
    on the rank's untagged rows (no tag, no sum); held against a plain
    version on the rank's plain rows whose value and gradient are summed
    over the data group by explicit all_reduces (potential rtol 1e-5,
    gradient rtol 1e-4 and atol 1e-4 of the largest component)."""
    from numpyro_tpu_torch.parallel import mesh as mesh_lib
    from numpyro_tpu_torch.parallel.data_shard import local_rows

    c = w_chains.shape[0]
    size = X.data_shard.size
    z = {"w": w_chains, "b": torch.linspace(-0.2, 0.2, c, device=device),
         "sigma": torch.linspace(-1.0, -0.5, c, device=device)}  # log sigma
    fn = infer_util.batched_value_and_grad(
        lambda z: infer_util.potential_energy(model_rows_normal, (X, y, size), {}, z))
    fn(z)  # warm
    mesh_lib.reset_collective_counts()
    _sync(device)
    t0 = time.perf_counter()
    value, grad = fn(z)
    _sync(device)
    out = {"ms": (time.perf_counter() - t0) * 1e3,
           "reduces": mesh_lib.collective_counts["over_data"]}
    # the same evaluation on the rank's plain rows (no tag, no sum): what the
    # tag and the sums add
    Xl, yl = local_rows(X), local_rows(y)
    untagged = infer_util.batched_value_and_grad(
        lambda z: infer_util.potential_energy(model_rows_normal, (Xl, yl, Xl.shape[0]), {}, z))
    untagged(z)
    _sync(device)
    t0 = time.perf_counter()
    untagged(z)
    _sync(device)
    out["untagged_ms"] = (time.perf_counter() - t0) * 1e3
    # the plain version: the rows' log-likelihood on this rank, its value and
    # gradient summed over the group, and the prior with its Jacobian
    half_log_2pi = 0.5 * math.log(2 * math.pi)

    def loglik(w, b, u):
        r = (yl - (Xl @ w + b)) * torch.exp(-u)
        return (-0.5 * r * r - u - half_log_2pi).sum()

    def prior(w, b, u):
        sigma = torch.exp(u)
        return (-0.5 * (w * w).sum() - 0.5 * b * b - 0.5 * sigma * sigma + math.log(2.0)
                - (D + 2) * half_log_2pi + u)

    def value_and_grad(f):
        g, v = torch.func.vmap(torch.func.grad_and_value(f, argnums=(0, 1, 2)))(
            z["w"], z["b"], z["sigma"])
        return v, torch.cat([g[0], g[1][:, None], g[2][:, None]], 1)

    ll, g_ll = value_and_grad(loglik)
    group = X.data_shard.group
    ll, g_ll = mesh_lib.all_reduce(ll, group), mesh_lib.all_reduce(g_ll, group)
    lp, g_lp = value_and_grad(prior)
    want, g_want = -(ll + lp), -(g_ll + g_lp)
    got = torch.cat([grad["w"], grad["b"][:, None], grad["sigma"][:, None]], 1)
    out["pe_err"] = ((value - want).abs() / want.abs()).max().item()
    out["g_need"] = ((got - g_want).abs() - 1e-4 * g_want.abs()).max().item() \
        / g_want.abs().max().item()
    out["finite"] = bool(torch.isfinite(value).all() and torch.isfinite(got).all())
    return out


def model_row_latent(X, y, size, check=False):
    """23g's model: covtype with a latent ``e`` for each row, as a JAX user
    writes it over ``shard_data``'s rows (every rank holds ``e`` whole and
    cuts it to its rows where it meets them); with ``check``, minus
    ``LSE_WEIGHT`` times a logsumexp over the rows of the logits of X scaled
    by its columns' largest magnitudes (the reductions' collectives)."""
    zero, one = torch.zeros((), device=X.device), torch.ones((), device=X.device)
    w = npt.sample("w", dist.Normal(torch.zeros(D, device=X.device), one).to_event(1))
    tau = npt.sample("tau", dist.HalfNormal(one))
    with npt.plate("N", size):
        e = npt.sample("e", dist.Normal(zero, one))
        npt.sample("y", dist.Bernoulli(logits=X @ w + tau * e), obs=y)
    if check:
        npt.factor("rows_lse", -LSE_WEIGHT * torch.logsumexp((X / X.abs().amax(0)) @ w, 0))


def row_latent_points(w_chains, size, device):
    """23g (i)'s points: phase 3's chains' coefficients, log tau from -4 to
    -2, and e from seed 23 on the device (alike on every rank)."""
    c = w_chains.shape[0]
    gen = torch.Generator(device=device).manual_seed(23)
    return {"w": w_chains, "tau": torch.linspace(-4.0, -2.0, c, device=device),
            "e": torch.randn((c, size), generator=gen, device=device)}


def row_latent_samples(w_chains, size, device):
    """23g (iii)'s posterior draws: the first ``ROW_LATENT_DRAWS`` of phase
    3's chains, tau from 0.2 to 1, e from seed 24 on the device."""
    gen = torch.Generator(device=device).manual_seed(24)
    return {"w": w_chains[:ROW_LATENT_DRAWS],
            "tau": torch.linspace(0.2, 1.0, ROW_LATENT_DRAWS, device=device),
            "e": torch.randn((ROW_LATENT_DRAWS, size), generator=gen, device=device)}


def row_latent_predictive(X, w_chains, size, device):
    """23g (iii): ``Predictive`` of ``y`` at ``row_latent_samples``' draws
    from seed 25 (one ``vmap``), on a rank's rows or all of them, and the
    logits the draws come from (computed beside it, as the model does)."""
    samples = row_latent_samples(w_chains, size, device)
    gen = torch.Generator(device=device).manual_seed(25)
    _sync(device)
    t0 = time.perf_counter()
    draws = Predictive(model_row_latent, samples, return_sites=["y"], device=device)(
        gen, X, None, size)["y"]
    _sync(device)
    s = time.perf_counter() - t0
    from numpyro_tpu_torch.parallel.data_shard import local_rows, shard_of

    shard = shard_of(draws)
    Xl = local_rows(X)
    start = 0 if shard is None else shard.start
    e = samples["e"][:, start:start + Xl.shape[0]]
    logits = torch.func.vmap(lambda w: Xl @ w)(samples["w"]) + samples["tau"][:, None] * e
    return {"y": local_rows(draws).to(torch.uint8).cpu(), "logits": logits.cpu(), "s": s,
            "tagged": shard is not None, "start": start}


def row_latent_leg(X, y, w_chains, w_map, mesh, device):
    """23g on a rank: (i) one batched evaluation of ``model_row_latent`` with
    its check at ``ROW_LATENT_RUN``'s chains, warm and timed, with its
    all_reduces, against a plain version on the rank's rows summed by
    explicit all_reduces (potential rtol 1e-5; the gradients of w and tau,
    and of e, rtol 1e-4 and atol 1e-4 of the largest component), the bits
    of e's gradient summed (alike on every rank when it is whole), and a
    gloo sum of a whole e panel timed; (ii) pooled NUTS from the MAP; (iii)
    ``row_latent_predictive``."""
    import torch.nn.functional as F

    from numpyro_tpu_torch.parallel import mesh as mesh_lib
    from numpyro_tpu_torch.parallel.data_shard import local_rows

    chains, warmup, samples, depth = ROW_LATENT_RUN
    size = X.data_shard.size
    z = row_latent_points(w_chains[:chains], size, device)
    fn = infer_util.batched_value_and_grad(lambda z: infer_util.potential_energy(
        model_row_latent, (X, y, size), {"check": True}, z))
    fn(z)  # warm
    mesh_lib.reset_collective_counts()
    _sync(device)
    t0 = time.perf_counter()
    value, grad = fn(z)
    _sync(device)
    out = {"ms": (time.perf_counter() - t0) * 1e3,
           "reduces": mesh_lib.collective_counts["over_data"],
           "e_shape": tuple(grad["e"].shape),
           "e_bits": grad["e"].contiguous().view(torch.int32).to(torch.int64).sum().item()}
    # the plain version: each part on this rank's rows, summed by all_reduces
    group = X.data_shard.group
    Xl, yl = local_rows(X), local_rows(y)
    start, rows = X.data_shard.start, Xl.shape[0]
    ar = functools.partial(mesh_lib.all_reduce, group=group)

    def loglik(w, u, e_rows):
        logits = Xl @ w + torch.exp(u) * e_rows
        return (yl * logits - F.softplus(logits)).sum()

    (g_w, g_u, g_rows), ll = torch.func.vmap(torch.func.grad_and_value(
        loglik, argnums=(0, 1, 2)))(z["w"], z["tau"], z["e"][:, start:start + rows])
    ll, g_w, g_u = ar(ll), ar(g_w), ar(g_u)
    g_e = torch.zeros_like(z["e"])
    g_e[:, start:start + rows] = g_rows
    g_e = ar(g_e)
    Xn = Xl / ar(Xl.abs().amax(0), op="max")
    m = ar(torch.func.vmap(lambda w: (Xn @ w).amax())(z["w"]), op="max")
    g_s, s = torch.func.vmap(torch.func.grad_and_value(
        lambda w, mm: torch.exp(Xn @ w - mm).sum()))(z["w"], m)
    s, g_s = ar(s), ar(g_s)
    lse, g_lse = m + torch.log(s), g_s / s[:, None]
    half_log_2pi = 0.5 * math.log(2 * math.pi)
    w, u, e = z["w"], z["tau"], z["e"]
    tau = torch.exp(u)
    lp = (-0.5 * (w * w).sum(-1) - D * half_log_2pi + math.log(2.0) - half_log_2pi
          - 0.5 * tau * tau + u - 0.5 * (e * e).sum(-1) - size * half_log_2pi)
    want = -(ll + lp - LSE_WEIGHT * lse)
    g_want = -torch.cat([g_w - w - LSE_WEIGHT * g_lse, (g_u + 1.0 - tau * tau)[:, None]], 1)
    e_want = -(g_e - e)
    got = torch.cat([grad["w"], grad["tau"][:, None]], 1)
    out["pe_err"] = ((value - want).abs() / want.abs()).max().item()
    out["g_need"] = ((got - g_want).abs() - 1e-4 * g_want.abs()).max().item() \
        / g_want.abs().max().item()
    out["e_need"] = ((grad["e"] - e_want).abs() - 1e-4 * e_want.abs()).max().item() \
        / e_want.abs().max().item()
    out["finite"] = bool(torch.isfinite(value).all() and torch.isfinite(got).all()
                         and torch.isfinite(grad["e"]).all())
    panel = torch.zeros_like(z["e"])
    ar(panel)
    _sync(device)
    t0 = time.perf_counter()
    ar(panel)
    _sync(device)
    out["sum_ms"] = (time.perf_counter() - t0) * 1e3
    del z, value, grad, g_e, e_want, panel
    # (ii) pooled NUTS from the MAP, tau small and e at 0
    start_at = {"w": w_map, "tau": torch.tensor(ROW_LATENT_TAU, device=device),
                "e": torch.zeros(size, device=device)}
    mcmc = MCMC(NUTS(model_row_latent, max_tree_depth=depth, pooled_adaptation=True,
                     init_strategy=init_to_value(values=start_at)),
                num_warmup=warmup, num_samples=samples, num_chains=chains,
                chain_method="parallel", mesh=mesh)
    glm.reset_launch_counts()
    mesh_lib.reset_collective_counts()
    t0 = time.perf_counter()
    mcmc.run(4, X, y, size)
    _sync(device)
    stats = mcmc.last_run_stats
    draws = mcmc.get_samples(group_by_chain=True)
    out["nuts"] = {
        "w": draws["w"].cpu(), "tau": draws["tau"].cpu(), "e_shape": tuple(draws["e"].shape),
        "e_bits": draws["e"].contiguous().view(torch.int32).to(torch.int64).sum().item(),
        "e_finite": bool(torch.isfinite(draws["e"]).all()),
        "evals": stats["potential_evals"], "init_traces": stats["init_traces"],
        "reduces": mesh_lib.collective_counts["over_data"], "s": time.perf_counter() - t0,
        "phases": {k: stats[f"{k}_s"] for k in ("init", "warmup", "sample")},
        "glm_launches": sum(glm.launch_counts.values())}
    del mcmc, draws
    # (iii) Predictive of y over the rows
    mesh_lib.reset_collective_counts()
    out["predictive"] = row_latent_predictive(X, w_chains, size, device)
    out["predictive"]["reduces"] = mesh_lib.collective_counts["over_data"]
    return out


def rows_leg(X, y, w_chains, w_map, mesh, device):
    """23e: ``model_rows`` on a rank's rows (``X``, ``y`` from
    ``shard_data``): the potential and gradient at ``w_chains`` with the
    all_reduces of that evaluation, then pooled NUTS from ``w_map``
    (``ROWS_NUTS``) on ``mesh``: its draws, evaluations, all_reduces over
    the data, GLM launches and seconds."""
    from numpyro_tpu_torch.parallel import mesh as mesh_lib

    size = X.data_shard.size

    def pe(z):
        return infer_util.potential_energy(model_rows, (X, y, size), {}, z)

    mesh_lib.reset_collective_counts()
    _sync(device)
    t0 = time.perf_counter()
    value, grad = infer_util.batched_value_and_grad(pe)({"w": w_chains})
    _sync(device)
    out = {"pe": value.cpu(), "grad": grad["w"].cpu(), "eval_s": time.perf_counter() - t0,
           "eval_reduces": mesh_lib.collective_counts["over_data"]}
    out["normal"] = normal_rows_eval(X, y, w_chains, device)
    chains, warmup, samples, depth, _ = ROWS_NUTS
    mcmc = MCMC(NUTS(model_rows, max_tree_depth=depth, pooled_adaptation=True,
                     init_strategy=init_to_value(values={"w": w_map})),
                num_warmup=warmup, num_samples=samples, num_chains=chains,
                chain_method="parallel", mesh=mesh)
    glm.reset_launch_counts()
    mesh_lib.reset_collective_counts()
    t0 = time.perf_counter()
    mcmc.run(3, X, y, size)
    stats = mcmc.last_run_stats
    out.update(draws=mcmc.get_samples(group_by_chain=True)["w"].cpu(),
               evals=stats["potential_evals"], init_traces=stats["init_traces"],
               reduces=mesh_lib.collective_counts["over_data"], s=time.perf_counter() - t0,
               phases={k: stats[f"{k}_s"] for k in ("init", "warmup", "sample")},
               glm_launches=sum(glm.launch_counts.values()))
    return out


def _ecs_step(state):
    """What 23f compares of an HMCECS state: indices, draws, potentials."""
    return {"idx": state.z["N"].cpu(), "w": state.z["w"].cpu(),
            "pe": state.hmc_state.potential_energy.cpu()}


def ecs_lean_step(X, y, w_map, device):
    """23f: 23c's HMCECS (``DATA_ECS``, the proxy at ``w_map``) in
    ``panel_mode="lean"`` on a rank's rows, from 23c's seed: init and one
    Gibbs step; the step's state, its all_reduces over the data axis, its
    potential evaluations and seconds."""
    from numpyro_tpu_torch.parallel import mesh as mesh_lib

    chains, warmup, _, depth, _ = DATA_ECS
    anchor = {"w": w_map}
    kernel = HMCECS(NUTS(model_ecs, max_tree_depth=depth, init_strategy=init_to_value(
        values=anchor)), num_blocks=NUM_BLOCKS, proxy=HMCECS.taylor_proxy(anchor),
        panel_mode="lean")
    kwargs = {"size": X.data_shard.size}
    glm.reset_launch_counts()
    t0 = time.perf_counter()
    state = kernel.init(torch.Generator(device=device).manual_seed(5), warmup, None, (X, y),
                        kwargs, num_chains=chains)
    _sync(device)
    init_s = time.perf_counter() - t0
    mesh_lib.reset_collective_counts()
    evals = infer_util.potential_evals
    t0 = time.perf_counter()
    state = kernel.sample(state, (X, y), kwargs)
    _sync(device)
    return {"step": _ecs_step(state), "reduces": mesh_lib.collective_counts["over_data"],
            "evals": infer_util.potential_evals - evals, "init_s": init_s,
            "s": time.perf_counter() - t0, "modes": dict(kernel.resolved_modes),
            "glm_launches": sum(glm.launch_counts.values())}


def ecs_leg(X, y, w_map, device):
    """23c: HMCECS with the Taylor proxy at ``w_map`` (phase 8d's MAP), its
    chains started there (``DATA_ECS``), through the per-step API; on a
    rank ``X`` and ``y`` are its rows of a data shard, in one process the
    whole data.  Returns the first evaluation's potential and gradient, the
    draws, the all_reduces over the data axis at setup and in the
    transitions, the potential evaluations and the seconds."""
    from numpyro_tpu_torch.parallel import mesh as mesh_lib

    chains, warmup, samples, depth, _ = DATA_ECS
    anchor = {"w": w_map}
    kernel = HMCECS(NUTS(model_ecs, max_tree_depth=depth, init_strategy=init_to_value(
        values=anchor)), num_blocks=NUM_BLOCKS, proxy=HMCECS.taylor_proxy(anchor))
    # the plate's size is the whole data's, which a data shard's tag holds
    kwargs = {"size": X.data_shard.size if hasattr(X, "data_shard") else X.shape[0]}
    glm.reset_launch_counts()
    mesh_lib.reset_collective_counts()
    t0 = time.perf_counter()
    state = kernel.init(torch.Generator(device=device).manual_seed(5), warmup, None, (X, y),
                        kwargs, num_chains=chains)
    setup = mesh_lib.collective_counts["over_data"]
    first = (state.hmc_state.potential_energy.cpu(), state.hmc_state.z_grad["w"].cpu())
    _sync(device)
    init_s = time.perf_counter() - t0
    mesh_lib.reset_collective_counts()
    evals = infer_util.potential_evals
    draws = []
    t0 = time.perf_counter()
    for i in range(warmup + samples):
        state = kernel.sample(state, (X, y), kwargs)
        if i == 0:
            first_step = _ecs_step(state)  # 23f's reference
        if i >= warmup:
            draws.append(state.z["w"])
    _sync(device)
    return {"first": first, "first_step": first_step, "draws": torch.stack(draws, 1).cpu(),
            "setup_reduces": setup,
            "reduces": mesh_lib.collective_counts["over_data"],
            "evals": infer_util.potential_evals - evals, "transitions": warmup + samples,
            "init_s": init_s, "s": time.perf_counter() - t0, "modes": dict(kernel.resolved_modes),
            "glm_launches": sum(glm.launch_counts.values())}


def chees_leg(data, chain_method, mesh=None):
    """23d: ChEES at ``CHEES_RUN``'s step size, trajectory length and step
    cap (``SHARDED_CHEES``): its draws, last adaptation state, split-kernel
    launches, evaluations (with the init trace) and seconds."""
    chains, warmup, samples = SHARDED_CHEES
    _, _, _, max_steps, step_size, traj = CHEES_RUN
    mcmc = MCMC(CheesHMC(model, step_size=step_size, trajectory_length=traj,
                         max_num_steps=max_steps),
                num_warmup=warmup, num_samples=samples, num_chains=chains,
                chain_method=chain_method, mesh=mesh)
    name = "glm_split" if data.device.type == "cuda" else "plain"
    glm.reset_launch_counts()
    t0 = time.perf_counter()
    mcmc.run(2, data)
    adapt = mcmc.last_state.adapt_state
    return {"draws": mcmc.get_samples(group_by_chain=True)["w"].cpu(),
            "adapt": (adapt.step_size.cpu(), adapt.trajectory_length.cpu(),
                      adapt.inverse_mass_matrix.cpu()),
            "launches": glm.launch_counts[name],
            "evals": mcmc.last_run_stats["potential_evals"] + CHEES_INIT_TRACES,
            "s": time.perf_counter() - t0}


def _wait_for(path, parent, since, limit, what):
    """Sleep until ``path`` exists; end this rank if the script (``parent``)
    is gone or ``limit`` seconds have passed ``since``."""
    while not os.path.exists(path):
        if os.getppid() != parent or time.time() - since > limit:
            raise SystemExit(f"no {what} from the script")
        time.sleep(0.05)


def phase23_rank(rank, tmp):
    """One rank of phase 23, in a process of its own, spawned as the script
    starts: joins the others through a file store in ``tmp`` and lays out
    the data the script wrote there; warms up on the card, first on a plain
    model while the script builds the kernels, then, once the ``built`` file
    is there, on its own data through ``glm_split``; writes ``warm<r>``,
    waits idle for the script's ``go`` file, runs (a) and (b) and writes what
    they give to ``tmp/rank<r>.pt``."""
    from numpyro_tpu_torch.parallel import (
        chain_data_mesh, chain_mesh, initialize_distributed, shard_data,
    )
    from numpyro_tpu_torch.parallel import mesh as mesh_lib

    parent = os.getppid()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(f"{tmp}/inputs.pt")
    spawned = inputs["spawned_at"]
    # "cards": one card a rank (cuda:LOCAL_RANK, NCCL); else every rank on one device
    device = mesh_lib.rank_device() if inputs["device"] == "cards" else torch.device(
        inputs["device"])
    backend = initialize_distributed(f"file://{tmp}/store", inputs["world"], rank, device=device)
    X, y = inputs["X"].to(device), inputs["y"].to(device)
    w_chains = inputs["w_chains"].to(device)
    del inputs["X"], inputs["y"]
    _sync(device)
    out = {"backend": backend, "joined_s": time.time() - spawned}
    # the first NUTS run of a fresh process pays for its first CUDA work and
    # model trace (7.5-14 s): a plain model pays most of it during the build
    MCMC(NUTS(warm_model, max_tree_depth=2), num_warmup=2, num_samples=2, num_chains=2,
         device=device).run(0, X[:WARM_ROWS], y[:WARM_ROWS])
    _sync(device)
    out["plain_warm_s"] = time.time() - spawned - out["joined_s"]
    _wait_for(f"{tmp}/built", parent, spawned, SCRIPT_LIMIT, "built kernels")
    out["built_at_s"] = time.time() - spawned
    mesh = chain_mesh(device=device)
    data = glm.prepare_glm_data(X, y, dtype="split")
    grid = chain_data_mesh(1, inputs["world"], device=device)
    Xs, ys = shard_data(X, grid), shard_data(y, grid)
    rows = glm.prepare_glm_data(Xs, ys, dtype="split")
    fused_rows = {name: glm.prepare_glm_data(Xs, ys, dtype=mode)
                  for name, mode in SHARD_MODES.items()}
    out["rows"] = rows.n
    del X, y
    MCMC(NUTS(model, max_tree_depth=2), num_warmup=2, num_samples=2, num_chains=2,
         device=device).run(0, data)
    _sync(device)
    out["warm_s"] = time.time() - spawned - out["built_at_s"]
    open(f"{tmp}/warm{rank}", "w").close()
    _wait_for(f"{tmp}/go", parent, spawned, SCRIPT_LIMIT, "go")

    go = torch.load(f"{tmp}/go.pt")

    # (a) the per-step leg with its chains sharded over the ranks
    chains, warmup, samples, depth = PER_STEP
    mcmc = MCMC(NUTS(model, max_tree_depth=depth), num_warmup=warmup, num_samples=samples,
                num_chains=chains, chain_method="parallel", mesh=mesh)
    mesh_lib.reset_collective_counts()
    out["a"] = _rank_model_run(mcmc, data, step=True)
    out["a"]["all_reduce"] = mesh_lib.collective_counts["all_reduce"]

    # (d) ChEES with its chains sharded over the ranks
    mesh_lib.reset_collective_counts()
    out["d"] = chees_leg(data, "parallel", mesh)
    out["d"]["all_reduce"] = mesh_lib.collective_counts["all_reduce"]
    del data

    # (b) the rows over the ranks: the kernel on this rank's rows, one sum
    t0 = time.perf_counter()
    mesh_lib.reset_collective_counts()
    ll, g = glm.sum_data_shards(*glm.glm_value_and_grad(w_chains, rows), rows)
    out["b_sum"] = (ll.cpu(), g.cpu(), mesh_lib.collective_counts["all_reduce"])
    if device.type == "cuda":
        # the ranks time the kernel in turn, so that none shares the card then
        d_pad, n_pad = rows.x_t.shape
        timed = {}
        for turn in range(grid.num_data_shards):
            mesh_lib.all_reduce(torch.zeros(1, device=device), None)
            for c in SHARD_CHAINS if turn == rank else ():
                w = w_chains[:c].contiguous()
                timed[c] = {"ms": cuda_ms(lambda: glm.glm_value_and_grad(w, rows)),
                            "bound": bound_ms("split", c, d_pad, n_pad)}
        ll, g = glm.glm_value_and_grad(w_chains, rows)
        torch.cuda.synchronize()
        reps, t1 = 20, time.perf_counter()
        for _ in range(reps):
            glm.sum_data_shards(ll, g, rows)
        torch.cuda.synchronize()
        out["b_timed"] = timed
        out["all_reduce_ms"] = (time.perf_counter() - t1) / reps * 1e3
        # the fused kernel's modes on the shard, timed in turns as above
        out["b_fused_timed"] = {name: {} for name in SHARD_MODES}
        for turn in range(grid.num_data_shards):
            mesh_lib.all_reduce(torch.zeros(1, device=device), None)
            for name in SHARD_MODES if turn == rank else ():
                d_pad, n_pad = fused_rows[name].x_t.shape
                for c in SHARD_CHAINS:
                    w = w_chains[:c].contiguous()
                    out["b_fused_timed"][name][c] = {
                        "ms": cuda_ms(lambda: glm.glm_value_and_grad(w, fused_rows[name])),
                        "bound": bound_ms(fused_rows[name].mode, c, d_pad, n_pad)}
        # a loop check's all_reduce: one count, read on the host
        t1 = time.perf_counter()
        for _ in range(reps):
            int(mesh_lib.all_reduce(torch.ones(1, dtype=torch.int64, device=device), None))
        out["check_ms"] = (time.perf_counter() - t1) / reps * 1e3
    out["b_checks_s"] = time.perf_counter() - t0
    c, warm_b, draws_b, depth_b = DATA_NUTS
    mcmc = MCMC(NUTS(model, max_tree_depth=depth_b, pooled_adaptation=True), num_warmup=warm_b,
                num_samples=draws_b, num_chains=c, chain_method="parallel", mesh=grid)
    mesh_lib.reset_collective_counts()
    out["b"] = _rank_model_run(mcmc, rows, step=False)
    out["b"]["all_reduce"] = mesh_lib.collective_counts["all_reduce"]
    out["b"]["ms_per_eval"] = out["b"]["s"] / out["b"]["evals"] * 1e3
    del rows
    # the fused kernel's modes through the model's op on the shard: one
    # launch and one all_reduce an evaluation of every chain
    out["b_fused"] = {}
    for name, rows_m in fused_rows.items():
        glm.reset_launch_counts()
        mesh_lib.reset_collective_counts()
        g, ll = torch.func.vmap(torch.func.grad_and_value(glm.bernoulli_logits_loglik),
                                in_dims=(0, None))(w_chains, rows_m)
        launched = "plain" if device.type == "cpu" else name
        out["b_fused"][name] = {"ll": ll.cpu(), "g": g.cpu(),
                                "launches": glm.launch_counts[launched],
                                "all_reduce": mesh_lib.collective_counts["all_reduce"]}
    del fused_rows

    # (e) a model written for the whole data over the rows, no GLM op
    out["e"] = rows_leg(Xs, ys, w_chains[: ROWS_NUTS[0]], go["w_map"].to(device), grid, device)

    # (c) HMCECS on the data shard; (f) one lean step of it
    out["c"] = ecs_leg(Xs, ys, go["w_map"].to(device), device)
    out["f"] = ecs_lean_step(Xs, ys, go["w_map"].to(device), device)

    # (g) a latent a row, held whole on every rank and cut to its rows
    t0 = time.perf_counter()
    out["g"] = row_latent_leg(Xs, ys, w_chains, go["w_map"].to(device), grid, device)
    out["g"]["s"] = time.perf_counter() - t0
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Ranks:
    """The ranks of phase 23, spawned from this script (``--phase23-rank``)
    with the data of the phase written beside their file store; they lay out
    their data, warm up once :meth:`warm_up` says the kernels are built, and
    wait for :meth:`finish` to start them.  Every rank is killed when the
    script ends, however it ends."""

    def __init__(self, X, y, w_chains, world=RANKS, device="cuda:0"):
        self.world, self.t0 = world, time.perf_counter()
        self.tmp = tempfile.TemporaryDirectory(prefix="phase23_")
        torch.save({"X": X.cpu(), "y": y.cpu(), "w_chains": w_chains.cpu(), "world": world,
                    "device": device, "spawned_at": time.time()}, f"{self.tmp.name}/inputs.pt")
        self.procs, self.logs = [], []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(world))
            self.logs.append(open(f"{self.tmp.name}/rank{rank}.log", "w"))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase23-rank", str(rank),
                 self.tmp.name], env=env, stdout=self.logs[-1], stderr=subprocess.STDOUT))
        atexit.register(self.stop)
        self.spawn_s = time.perf_counter() - self.t0

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()

    def _fail(self, what, wall):
        self.stop()
        for rank, p in enumerate(self.procs):
            with open(f"{self.tmp.name}/rank{rank}.log") as f:
                print(f"[ranks] rank {rank} (exit {p.returncode}):\n{f.read()[-4000:]}",
                      flush=True)
        raise SystemExit(f"phase 23: {what} after {wall:.1f} s; ranks exited "
                         f"{[p.returncode for p in self.procs]}")

    def warm_up(self):
        """Tell the ranks that the kernels are built and wait until every
        rank has warmed up on the card; returns the seconds waited."""
        t0 = time.perf_counter()
        open(f"{self.tmp.name}/built", "w").close()
        warm = [f"{self.tmp.name}/warm{r}" for r in range(self.world)]
        while not all(map(os.path.exists, warm)):
            if (any(p.poll() is not None for p in self.procs)
                    or time.perf_counter() - t0 > RANK_TIMEOUT):
                self._fail("the ranks did not warm up", time.perf_counter() - t0)
            time.sleep(0.05)
        self.warm_wait_s = time.perf_counter() - t0
        return self.warm_wait_s

    def finish(self, go):
        """Start the ranks, handing them ``go`` (phase 8d's MAP as ``w_map``),
        and wait for them; returns their results and the seconds from the
        start to their end."""
        t0 = time.perf_counter()
        torch.save(go, f"{self.tmp.name}/go.pt")
        open(f"{self.tmp.name}/go", "w").close()
        while any(p.poll() is None for p in self.procs):
            if (any(p.poll() not in (None, 0) for p in self.procs)
                    or time.perf_counter() - t0 > RANK_TIMEOUT):
                break
            time.sleep(0.05)
        self.stop()
        wall = time.perf_counter() - t0
        if any(p.returncode for p in self.procs):
            self._fail("the ranks failed", wall)
        res = [torch.load(f"{self.tmp.name}/rank{r}.pt") for r in range(self.world)]
        self.tmp.cleanup()
        return res, wall


def phase_ranks(ranks, per_step, X, y, w_chains, w_map, true_w):
    """Phase 23 (the ranks started by :class:`Ranks`), held against phase 4's
    per-step leg (``per_step``: its draws and potential energies), against
    each kernel on ``X``, ``y`` at phase 3's ``w_chains``, and against 23c's
    and 23d's legs in this process (HMCECS anchored at ``w_map``, phase 8d's
    MAP, its posterior means held to ``true_w``).  Returns the phase's wall
    from the start of those legs, the ranks' results and the launches of
    each kernel on the main path: a list of each rank's, and this process's."""
    refs = {}
    for name, mode in (("glm_split", "split"), *SHARD_MODES.items()):
        whole = glm.prepare_glm_data(X, y, dtype=mode)
        refs[name] = tuple(t.cpu() for t in glm.glm_value_and_grad(w_chains, whole))
        del whole
    # the scale of 23c's first gradient: its terms' magnitudes summed at the MAP
    w_dev = torch.as_tensor(w_map, device=X.device)
    g_scale = (X.abs() * (y - torch.sigmoid(X @ w_dev)).abs()[:, None]).sum(0).cpu()
    t0 = time.perf_counter()
    # 23c's and 23d's legs in this process, before the ranks start
    ecs_ref = ecs_leg(X, y, w_dev, X.device)
    data = glm.prepare_glm_data(X, y, dtype="split")
    chees_ref = chees_leg(data, "vectorized")
    del data
    # 23g's Predictive on all rows
    pred_ref = row_latent_predictive(X, w_chains, N, X.device)
    ref_s = time.perf_counter() - t0
    res, wall = ranks.finish({"w_map": torch.as_tensor(w_map).cpu()})
    wall += ref_s
    world = ranks.world

    # (a) the chain-sharded per-step leg against phase 4's
    ref_draws, ref_pe = per_step["draws"].cpu(), per_step["pe"].cpu()
    for r, got in enumerate(res):
        a = got["a"]
        same = torch.equal(a["draws"], ref_draws) and torch.equal(a["pe"], ref_pe)
        log(f"[ranks] 23a rank {r} ({got['backend']}; joined and holding the data "
            f"{got['joined_s']:.1f} s after the spawn, the plain warm-up {got['plain_warm_s']:.1f} "
            f"s, told the kernels were built {got['built_at_s']:.1f} s after the spawn, warmed up "
            f"on its data in {got['warm_s']:.1f} s): chains sharded {world} x "
            f"{PER_STEP[0] // world}, "
            f"{a['evals'] - 1} evaluations, glm_split launches {a['launches']}, all_reduce "
            f"{a['all_reduce']} (a loop check's {got.get('check_ms', float('nan')):.3f} ms), "
            f"{a['s']:.2f} s ("
            + ", ".join(f"{k} {v:.2f} s" for k, v in a["phases"].items())
            + "); draws and potential energies "
            f"equal phase 4's per-step leg bit for bit: {same} (largest difference "
            f"{(a['draws'] - ref_draws).abs().max().item():.3e}, "
            f"{(a['pe'] - ref_pe).abs().max().item():.3e})")
        if a["launches"] != a["evals"]:
            raise SystemExit(f"23a rank {r}: {a['launches']} launches for {a['evals'] - 1} "
                             "evaluations and 1 init trace")
        if not same:
            raise SystemExit(f"23a rank {r}: the sharded leg's draws differ from phase 4's")

    # (b) the data-sharded sums against each kernel on the whole X
    for r, got in enumerate(res):
        checks = {"glm_split": (*got["b_sum"][:2], got["b_sum"][2], 1)}
        for name in SHARD_MODES:
            f = got["b_fused"][name]
            checks[name] = (f["ll"], f["g"], f["all_reduce"], f["launches"])
        timed = {"glm_split": got.get("b_timed", {}), **got.get("b_fused_timed", {})}
        for name, (ll, g, reduces, launches) in checks.items():
            ll_ref, g_ref = refs[name]
            ll_rtol, g_rtol, g_atol = glm.kernel_tolerances(glm._mode(KERNELS[name][0]), N)
            ll_err = ((ll - ll_ref).abs() / ll_ref.abs()).max().item()
            g_need = ((g - g_ref).abs() - g_rtol * g_ref.abs()).max().item()
            log(f"[ranks] 23b rank {r} {name}: {got['rows']:,} rows, one all_reduce ({reduces}) "
                f"and {launches} launch for {CHAINS} chains; loglik max rel err {ll_err:.3e} "
                f"(rtol {ll_rtol}), gradient least atol {g_need:.3e} (atol {g_atol:.3e}) against "
                f"{name} on all {N:,} rows; "
                + "; ".join(f"at B = {c} on the shard {t['ms']:.3f} ms (bound "
                            f"{t['bound'][0]:.4f} ms, {t['bound'][1]}, share "
                            f"{t['bound'][0] / t['ms']:.3f})"
                            for c, t in timed.get(name, {}).items()))
            if reduces != 1 or launches != 1 or ll_err > ll_rtol or g_need > g_atol:
                raise SystemExit(f"23b rank {r}: the data-sharded {name} disagrees with {name} "
                                 "on X")
        b = got["b"]
        log(f"[ranks] 23b rank {r}: all_reduce of ({CHAINS}, {D + 1}) "
            f"{got.get('all_reduce_ms', float('nan')):.3f} ms; these checks "
            f"{got['b_checks_s']:.2f} s; pooled NUTS {DATA_NUTS[1]} + "
            f"{DATA_NUTS[2]} at {DATA_NUTS[0]} chains: {b['evals']} evaluations and init "
            f"traces, glm_split launches {b['launches']}, all_reduce {b['all_reduce']}, "
            f"{b['ms_per_eval']:.2f} ms an evaluation, {b['s']:.2f} s")
        if b["launches"] != b["evals"] or not torch.isfinite(b["draws"]).all():
            raise SystemExit(f"23b rank {r}: {b['launches']} launches for {b['evals']} "
                             "evaluations and init traces, or draws that are not finite")
        if b["draws"].shape != (DATA_NUTS[0], DATA_NUTS[2], D) or not torch.equal(
                b["draws"], res[0]["b"]["draws"]):
            raise SystemExit(f"23b rank {r}: its draws differ from rank 0's")

    # (c) HMCECS on the data mesh against the same leg in this process
    chains_c, warm_c, draws_c, depth_c, gate_c = DATA_ECS
    pe_ref, g_ref = ecs_ref["first"]
    for r, c in enumerate([ecs_ref] + [got["c"] for got in res]):
        tag = "23c in one process on all rows" if r == 0 else f"23c rank {r - 1}"
        pe, g = c["first"]
        pe_err = ((pe - pe_ref).abs() / pe_ref.abs()).max().item()
        g_err = ((g - g_ref).abs() / g_scale).max().item()
        err = (c["draws"].double().mean((0, 1)) - torch.from_numpy(true_w).double()).abs().max()
        counts = (f"{c['setup_reduces']} at setup, {c['reduces']} in {c['transitions']} Gibbs "
                  f"steps ({c['reduces'] / c['transitions']:.2f} a step, "
                  f"{(c['reduces'] - c['transitions']) / c['evals']:.2f} an evaluation)"
                  if r else "none (one process)")
        log(f"[ranks] {tag}: HMCECS {chains_c} chains, {warm_c} + {draws_c} at depth {depth_c}, "
            f"subsample {SUBSAMPLE}, {NUM_BLOCKS} blocks, proxy at phase 8d's MAP, resolved "
            f"{c['modes']}; init {c['init_s']:.2f} s, transitions {c['s']:.2f} s, "
            f"{c['evals']} evaluations ({c['s'] / c['evals'] * 1e3:.2f} ms each); all_reduces "
            f"over the data axis: {counts}; first potential max rel err {pe_err:.3e}, gradient "
            f"max error {g_err:.3e} of its terms' magnitudes (both {DATA_ECS_RTOL}); max "
            f"|mean(w) - true_w| {err.item():.4f} (gate {gate_c})")
        if c["glm_launches"] or not torch.isfinite(c["draws"]).all():
            raise SystemExit(f"{tag}: a GLM launch, or draws that are not finite")
        if pe_err > DATA_ECS_RTOL or g_err > DATA_ECS_RTOL or not err < gate_c:
            raise SystemExit(f"{tag}: disagrees with the one-process leg or misses its gate")
        if r and (c["reduces"] != c["transitions"] or c["modes"] != ecs_ref["modes"]
                  or not torch.equal(c["draws"], res[0]["c"]["draws"])):
            raise SystemExit(f"{tag}: not one all_reduce a Gibbs step, another mode, or "
                             "draws other than rank 0's")

    # (d) ChEES sharded over the chains against the same leg in this process
    for r, got in enumerate(res):
        d = got["d"]
        same = torch.equal(d["draws"], chees_ref["draws"]) and all(
            torch.equal(u, v) for u, v in zip(d["adapt"], chees_ref["adapt"]))
        log(f"[ranks] 23d rank {r}: CheesHMC {SHARDED_CHEES[0]} chains sharded {world} x "
            f"{SHARDED_CHEES[0] // world}, {SHARDED_CHEES[1]} + {SHARDED_CHEES[2]}: "
            f"{d['evals']} evaluations and init traces, glm_split launches {d['launches']}, "
            f"all_reduce {d['all_reduce']}, {d['s']:.2f} s (one process: {chees_ref['s']:.2f} "
            f"s); draws and adaptation equal the one-process leg's bit for bit: {same}")
        if d["launches"] != d["evals"] or not same:
            raise SystemExit(f"23d rank {r}: {d['launches']} launches for {d['evals']} "
                             "evaluations, or draws other than the one-process leg's")
    # (e) the model over the rows against 23b's glm_fused f32 on the shard
    chains_e, warm_e, draws_e, depth_e, gate_e = ROWS_NUTS
    ll_rtol, g_rtol, g_atol = glm.kernel_tolerances("f32", N)
    for r, got in enumerate(res):
        e, f = got["e"], got["b_fused"]["glm_fused_f32"]
        w = w_chains[:chains_e].cpu()
        # the likelihood's part of the potential: the potential is minus the
        # log-likelihood and the prior's log-density, whose gradient is -w
        prior = -0.5 * (w**2).sum(-1) - 0.5 * D * math.log(2 * math.pi)
        ll, g = -e["pe"] - prior, -e["grad"] + w
        ll_err = ((ll - f["ll"][:chains_e]).abs() / f["ll"][:chains_e].abs()).max().item()
        g_need = ((g - f["g"][:chains_e]).abs() - g_rtol * f["g"][:chains_e].abs()).max().item()
        err = (e["draws"].double().mean((0, 1)) - torch.from_numpy(true_w).double()).abs().max()
        log(f"[ranks] 23e rank {r}: Bernoulli(logits=X @ w) with obs=y on {got['rows']:,} rows, "
            f"no GLM op; at {chains_e} chains loglik max rel err {ll_err:.3e} (rtol {ll_rtol}), "
            f"gradient least atol {g_need:.3e} (atol {g_atol:.3e}) against 23b's glm_fused f32 "
            f"on the shard, {e['eval_reduces']} all_reduces over the data, "
            f"{e['eval_s'] * 1e3:.1f} ms; pooled NUTS {warm_e} + {draws_e} at depth {depth_e} "
            f"from the MAP: {e['evals']} evaluations + {e['init_traces']} init trace, "
            f"{e['reduces']} all_reduces over the data ({e['reduces'] / e['evals']:.2f} an "
            f"evaluation), {e['s']:.2f} s ("
            + ", ".join(f"{k} {v:.2f} s" for k, v in e["phases"].items())
            + f", {e['s'] / e['evals'] * 1e3:.2f} ms an evaluation); max |mean(w) - true_w| "
            f"{err.item():.4f} (gate {gate_e}); GLM launches {e['glm_launches']}")
        if ll_err > ll_rtol or g_need > g_atol or e["eval_reduces"] != 2:
            raise SystemExit(f"23e rank {r}: the model over the rows disagrees with glm_fused "
                             "f32 on the shard, or not two all_reduces an evaluation")
        if (e["glm_launches"] or not torch.isfinite(e["draws"]).all() or not err < gate_e
                or e["draws"].shape != (chains_e, draws_e, D)
                or not torch.equal(e["draws"], res[0]["e"]["draws"])):
            raise SystemExit(f"23e rank {r}: a GLM launch, bad draws, draws other than rank "
                             "0's, or a missed gate")
        nm = e["normal"]
        log(f"[ranks] 23e rank {r}: Normal(X @ w + b, sigma) with obs=y at {chains_e} chains: "
            f"one evaluation {nm['ms']:.1f} ms, {nm['reduces']} all_reduces over the data "
            f"(on the rank's untagged rows, no sums: {nm['untagged_ms']:.1f} ms); "
            f"potential max rel err {nm['pe_err']:.3e} (rtol 1e-5), gradient least atol "
            f"{nm['g_need']:.3e} of its largest component (1e-4) against the plain version "
            "summed by explicit all_reduces")
        if not nm["finite"] or nm["pe_err"] > 1e-5 or nm["g_need"] > 1e-4:
            raise SystemExit(f"23e rank {r}: the Normal model over the rows disagrees with "
                             "its plain version")

    # (f) one lean Gibbs step against 23c's first step in carry mode
    for r, got in enumerate(res):
        f, ref = got["f"], got["c"]["first_step"]
        same = all(torch.equal(f["step"][k], ref[k]) for k in ref)
        log(f"[ranks] 23f rank {r}: HMCECS {DATA_ECS[0]} chains, one Gibbs step in "
            f"{f['modes']}: init {f['init_s']:.2f} s, the step {f['s']:.2f} s, "
            f"{f['evals']} evaluations ({f['s'] / f['evals'] * 1e3:.2f} ms each), "
            f"{f['reduces']} all_reduces over the data (one an evaluation and one for the "
            f"proxy's statistics); indices, draws and potentials equal 23c's first step in "
            f"carry mode bit for bit: {same}")
        if (not same or f["modes"].get("panel") != "lean" or f["glm_launches"]
                or f["reduces"] != f["evals"] + 1):
            raise SystemExit(f"23f rank {r}: the lean step differs from carry mode's, or not "
                             "one all_reduce an evaluation")
    # (g) a latent a row: the evaluation against its plain version, NUTS,
    # Predictive against this script's on all rows
    chains_g, warm_g, draws_g, depth_g = ROW_LATENT_RUN
    gate_g = ROWS_NUTS[4]
    for r, got in enumerate(res):
        g, nuts, pred = got["g"], got["g"]["nuts"], got["g"]["predictive"]
        err = (nuts["w"].double().mean((0, 1)) - torch.from_numpy(true_w).double()).abs().max()
        start, rows = pred["start"], pred["y"].shape[-1]
        ref_y, ref_l = pred_ref["y"][:, start:start + rows], pred_ref["logits"][:, start:start + rows]
        differ = int((pred["y"] != ref_y).sum())
        logit_diff = (pred["logits"] - ref_l).abs().max().item()
        # a draw differs only where the uniform falls between the two
        # probabilities: a Poisson count of mean sum |dp| at most
        expected = (torch.sigmoid(pred["logits"].double())
                    - torch.sigmoid(ref_l.double())).abs().sum().item()
        log(f"[ranks] 23g rank {r}: a latent a row, e whole ({g['e_shape'][1]:,} a chain): one "
            f"evaluation at {chains_g} chains with a logsumexp and column maxima over the rows "
            f"{g['ms']:.1f} ms, {g['reduces']} all_reduces over the data (a gloo sum of the "
            f"whole e panel {g['sum_ms']:.1f} ms); potential max rel err {g['pe_err']:.3e} "
            f"(rtol 1e-5), gradient least atol {g['g_need']:.3e} (w, tau) and "
            f"{g['e_need']:.3e} (e) of the largest component (1e-4) against the plain version "
            f"summed by explicit all_reduces; pooled NUTS {warm_g} + {draws_g} at depth "
            f"{depth_g} from the MAP: {nuts['evals']} evaluations + {nuts['init_traces']} init "
            f"trace, {nuts['reduces']} all_reduces over the data, {nuts['s']:.2f} s ("
            + ", ".join(f"{k} {v:.2f} s" for k, v in nuts["phases"].items())
            + f", {nuts['s'] / max(nuts['evals'], 1) * 1e3:.1f} ms an evaluation); max "
            f"|mean(w) - true_w| {err.item():.4f} (gate {gate_g}); Predictive of "
            f"{ROW_LATENT_DRAWS} draws over the rows {pred['s']:.3f} s ({pred_ref['s']:.3f} s on "
            f"all rows in this process), {pred['reduces']} all_reduces: {differ} of "
            f"{pred['y'].numel():,} draws differ from this script's (expected at most "
            f"{expected:.3f}), largest logit difference {logit_diff:.3e}; 23g {g['s']:.2f} s")
        if (not g["finite"] or g["pe_err"] > 1e-5 or g["g_need"] > 1e-4 or g["e_need"] > 1e-4
                or g["e_shape"] != (chains_g, N) or g["e_bits"] != res[0]["g"]["e_bits"]
                or g["reduces"] != 7):
            raise SystemExit(f"23g rank {r}: the evaluation disagrees with its plain version, "
                             "e's gradient is not whole or not alike on the ranks, or not 7 "
                             "all_reduces")
        if (nuts["glm_launches"] or not nuts["e_finite"] or not torch.isfinite(nuts["w"]).all()
                or nuts["e_shape"] != (chains_g, draws_g, N) or not err < gate_g
                or not torch.equal(nuts["w"], res[0]["g"]["nuts"]["w"])
                or not torch.equal(nuts["tau"], res[0]["g"]["nuts"]["tau"])
                or nuts["e_bits"] != res[0]["g"]["nuts"]["e_bits"]):
            raise SystemExit(f"23g rank {r}: NUTS launched a GLM kernel, drew other than rank "
                             "0's, drew e other than whole, or missed its gate")
        if not pred["tagged"] or differ > 8 + 4 * expected:
            raise SystemExit(f"23g rank {r}: Predictive's draws are not the rank's rows, or "
                             f"{differ} differ from this script's")
    launches = {
        "glm_split": [got["a"]["launches"] + got["b"]["launches"] + got["d"]["launches"]
                      for got in res] + [chees_ref["launches"]],
        **{name: [got["b_fused"][name]["launches"] for got in res] + [0]
           for name in SHARD_MODES},
    }
    log(f"[ranks] phase 23: {wall:.1f} s from the one-process legs of 23c and 23d "
        f"({ref_s:.1f} s) to the ranks' end, {ranks.warm_wait_s:.1f} s waiting for the warm-up, "
        f"the spawn {ranks.spawn_s:.1f} s; launches per rank and in this process {launches}")
    return wall, res, launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this smoke run needs an NVIDIA GPU")
    card = smi()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    device = torch.device("cuda", 0)
    # full-f32 matmuls in the plain versions (the counterpart of the JAX
    # driver's matmul_precision="highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    X, y, true_w, w_chains = make_data(device)
    # phase 23's ranks start now: they reach the card, lay out their data and
    # warm up on a plain model while the kernels build
    ranks = Ranks(X, y, w_chains)
    log(f"[ranks] {ranks.world} ranks spawned for phase 23 in {ranks.spawn_s:.1f} s")
    t0 = time.perf_counter()
    _cuda.load()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_cuda.build_info['path']}; the ranks starting beside the build)")
    for line in _cuda.ptxas_summary():
        log(f"[build] {line}")
    # and finish their warm-up through glm_split before anything is timed
    log(f"[ranks] waited {ranks.warm_up():.1f} s for the ranks to warm up")
    kernels = phase_kernels(X, y, w_chains)

    glm.reset_launch_counts()
    stats = {name: phase_main(X, y, true_w, name) for name in RUNS}
    checkpoints = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    resume = phase_per_step(X, y, f"{checkpoints.name}/per_step_warm.pt")
    counts = dict(glm.launch_counts)

    split = stats["glm_split"]
    split_ms = kernels["glm_split"]["ms"]
    share = split["potential_evals_sample"] * split_ms / 1e3 / split["sample_s"]
    share_all = split["potential_evals"] * split_ms / 1e3 / (
        split["warmup_s"] + split["sample_s"])
    log(f"[main] split kernel share of wall time: sampling {share:.3f}, "
        f"warmup+sampling {share_all:.3f} (launches x {split_ms:.3f} ms)")
    phase_fused(X, y)

    t8 = time.perf_counter()
    svi_launches, w_map = phase_svi(X, y, true_w, split["posterior"], kernels)
    log(f"[svi] phase 8: {time.perf_counter() - t8:.1f} s, glm_split launches {svi_launches}")

    ecs = phase_ecs(X, y, true_w, ECS_MAIN, expect={"proxy": "stats", "panel": "carry"})
    for panel_mode, proxy_mode in (("bf16", "stats"), ("lean", "stats"), ("carry", "recompute")):
        phase_ecs(X, y, true_w, ECS_MODES, panel_mode, proxy_mode,
                  anchor=w_map if panel_mode == "lean" else None)

    dense, dense_counts = phase_dense(X, y, true_w)
    log(f"[dense] 7e covtype, split mode: {dense['ms_per_eval']:.2f} ms per evaluation under "
        f"the pooled dense mass against {split['ms_per_eval']:.2f} under phase 4's diagonal one; "
        f"glm_split launches {dense_counts['glm_split']} here, {counts['glm_split']} in phase 4")
    phase_eight_schools(device)
    phase_sv(device)
    phase_hmm(device)
    phase_samplers(device, ecs["ms_per_eval"])
    t13 = time.perf_counter()
    chees_launches = phase_chees(X, y, true_w, split)
    phase_guides(device, ecs["ms_per_eval"])
    wall = time.perf_counter() - t13
    log(f"[chees/guides] phase 13: {wall:.1f} s, about {wall * 24.0 / ecs['ms_per_eval']:.1f} s "
        f"on a host where the ECS leg takes 24.0 ms per evaluation (here "
        f"{ecs['ms_per_eval']:.2f}; budget 20 s)")
    t14 = time.perf_counter()
    guide, res, iaf_data, iaf_launches, iaf_ms = phase_iaf(X, y, true_w)
    t14b = time.perf_counter()
    neutra_launches = phase_neutra(X, y, true_w, guide, res.params, iaf_data, split)
    wall_b = time.perf_counter() - t14b
    del iaf_data
    wall_ce = phase_flow_examples(device)
    wall = time.perf_counter() - t14
    log(f"[flows] phase 14: {wall:.1f} s (14a {t14b - t14:.1f} s at {iaf_ms:.2f} ms a step, "
        f"14b {wall_b:.1f} s, 14c-e {wall_ce:.1f} s), about "
        f"{wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes 24.0 ms per "
        f"evaluation (budget 30 s); glm_split launches 14a {iaf_launches}, 14b {neutra_launches}")

    t15 = time.perf_counter()
    walls = phase_fifteen(device)
    wall = time.perf_counter() - t15
    log(f"[semi] phase 15: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"), about {wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes "
        f"24.0 ms per evaluation (budget 12 s)")

    t16 = time.perf_counter()
    walls, ms, predictive_s = phase_sixteen(device)
    wall = time.perf_counter() - t16
    log(f"[discrete] phase 16: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f} s"
                                                           for k, v in walls.items())
        + f"; 16a {ms['16a']:.2f} and 16b {ms['16b']:.2f} ms per evaluation, Predictive "
        f"{predictive_s:.3f} s), about {wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where "
        f"the ECS leg takes 24.0 ms per evaluation (budget 10 s)")

    t17 = time.perf_counter()
    walls, ms, syncs, _ = phase_seventeen(device)
    wall = time.perf_counter() - t17
    log(f"[structured] phase 17: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f} s"
                                                             for k, v in walls.items())
        + f"; 17a {ms:.2f} ms and {syncs['17a']} host syncs, 17b {syncs['17b']} host syncs per "
        f"evaluation), about "
        f"{wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes 24.0 ms per "
        f"evaluation (budget 5 s)")

    t18 = time.perf_counter()
    walls, ms, syncs = phase_eighteen(device)
    wall = time.perf_counter() - t18
    log(f"[dsl] phase 18: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; 18a {ms:.2f} ms and {syncs['18a']} host syncs per evaluation; 18b {syncs['off']} "
        f"with validation off, twin {syncs['twin']}, on {syncs['on']}), about "
        f"{wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes 24.0 ms per "
        f"evaluation (budget 3 s)")

    t19 = time.perf_counter()
    walls, tail_launches, try_s = phase_nineteen(X, y)
    wall = time.perf_counter() - t19
    log(f"[tail] phase 19: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; one init_to_median try at {INIT_CHAINS} chains {try_s:.3f} s; glm_split launches "
        f"19a {tail_launches['19a']}, 19b {tail_launches['19b']}), about "
        f"{wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes 24.0 ms per "
        f"evaluation (budget 4 s)")

    t20 = time.perf_counter()
    walls, ms, ms_nested, syncs = phase_twenty(device)
    wall = time.perf_counter() - t20
    log(f"[contrib] phase 20: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f} s"
                                                         for k, v in walls.items())
        + f"; 20a {ms:.2f} ms per evaluation, the nested runs "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms_nested.items())
        + f" ms per batched evaluation; host syncs per evaluation {syncs}), about "
        f"{wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes 24.0 ms per "
        f"evaluation (budget 8 s)")

    t21 = time.perf_counter()
    walls, ms, syncs, stein_launches = phase_twenty_one(X, y, true_w, split["posterior"], kernels)
    wall = time.perf_counter() - t21
    log(f"[stein] phase 21: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f} s"
                                                       for k, v in walls.items())
        + f"; ms per step 21a {ms['21a']:.2f}, 21b {ms['21b']:.2f}; host syncs in a step "
        f"{syncs}; glm_split launches 21a {stein_launches}), about "
        f"{wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes 24.0 ms per "
        f"evaluation (budget 6 s)")

    t22 = time.perf_counter()
    walls, ms, syncs, resume_launches = phase_twenty_two(device, resume)
    checkpoints.cleanup()
    per_step = {"draws": resume["draws"], "pe": resume["pe"]}
    del resume
    wall = time.perf_counter() - t22
    log(f"[port tail] phase 22: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f} s"
                                                          for k, v in walls.items())
        + f"; ms per step 22b {ms['22b']:.2f}, 22c {ms['22c']:.2f}; host syncs in a 22b step "
        f"{syncs}; glm_split launches 22a {resume_launches}), about "
        f"{wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes 24.0 ms per "
        f"evaluation (budget 4 s)")

    t23 = time.perf_counter()
    _, rank_results, rank_launches = phase_ranks(ranks, per_step, X, y, w_chains, w_map,
                                                 true_w)
    wall = time.perf_counter() - t23 + ranks.spawn_s + ranks.warm_wait_s
    log(f"[ranks] phase 23: {wall:.1f} s with the spawn and the wait for the warm-up, about "
        f"{wall * 24.0 / ecs['ms_per_eval']:.1f} s on a host where the ECS leg takes 24.0 ms per "
        f"evaluation (budget 14 s)")
    for name in kernels:
        for c in SHARD_CHAINS:
            timed = [got["b_timed"] if name == "glm_split" else got["b_fused_timed"][name]
                     for got in rank_results]
            kernels[name][f"ms_on_a_shard_at_{c}_chains"] = [t[c]["ms"] for t in timed]
            kernels[name][f"bound_ms_on_a_shard_at_{c}_chains"] = timed[0][c]["bound"][0]
        kernels[name]["launches_per_rank_phase23"] = rank_launches[name][:-1]

    for name, entry in kernels.items():
        entry["launches"] = counts[name] + dense_counts[name] + sum(rank_launches[name]) + (
            svi_launches + chees_launches + iaf_launches + neutra_launches
            + tail_launches["19a"] + tail_launches["19b"] + stein_launches + resume_launches
            if name == "glm_split" else 0)
        if counts[name] == 0:
            raise SystemExit(f"{name} was never launched on the main path")
    if dense_counts["glm_split"] == 0:
        raise SystemExit("glm_split was never launched on the dense leg")
    print(card, flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--phase23-rank":  # a rank of phase 23
        phase23_rank(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
