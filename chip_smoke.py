#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each failing loudly (an exception or a failed check exits non-zero):

1. Device: requires CUDA; prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) and
   the torch and CUDA versions.
2. Build: compiles every kernel under ``photon_ml_torch/csrc`` into
   ``build/torch_kernels/`` (one ``nvcc`` per source, all at once).
3. Dense kernels against their plain versions, on the card: the fused GLM
   value+gradient (4 losses x {f32, bf16} x {no normalization, scaling,
   standardization} at n=2^18, d=512, plus ragged n=1000/d=123 and
   n=1001/d=4099, the widest one-pass plan at d=8192 and the two-pass form
   at d=8200), zero-weight rows included, each called twice and required
   bitwise equal; and the ordered reduction of its partials.
4. The dense slice: ``train_glm`` at n=2^18, d=512 on an f32 logistic
   dataset made with numpy from ``--seed``: an L-BFGS λ path with
   standardization, an elastic-net λ (OWL-QN), a TRON solve and an L-BFGS
   solve on a bf16 feature block, with the launch counters set to 0 just
   before and read just after. The L-BFGS path is repeated through the
   closed form (``use_kernel=False``) and the final objective values must
   agree; a small problem solved on the card must agree with the CPU in f64.
5. The sparse slice, at the shapes of bench.py's giant-FE rows (data made
   with numpy from ``--seed``), ``train_glm`` on ``SparseLabeledPointBatch``:
   a. ELL, n=2^19, d=10^7, 32 random + 4 planted columns per row, scaled by
      ``summarize_sparse``'s deviations: L-BFGS over λ in {0.1, 1}, an
      elastic-net λ (OWL-QN), L-BFGS on bf16 values, variances (the sparse
      Hessian diagonal), the scaled L-BFGS path again through the plain
      gather-sum (``use_kernel=False``) and through the kernel (gaps
      printed), and bench.py's unnormalized λ path {0.1, 1} (L-BFGS, up to
      100 iterations) through the kernel and the plain gather-sum (final
      values within rel 1e-4); the
      unnormalized λ=0.1 model's AUC on 2^16 held-out rows of the same
      planted model must exceed 0.6;
   b. hybrid, n=2^19, d=10^7, Zipf columns, a 256-column dense head: L-BFGS;
   c. hybrid, n=2^18, d=10^8, Zipf columns, a 512-column head: TRON (CG
      capped at 2), the hybrid Hessian-vector path.
   On each path's own inputs, before its solves, the gather kernel is held
   against its plain version in f64 (twice, bitwise equal; per row
   ``|k - p| <= 1e-5 * sum|vals*w|``): ELL f32 and bf16, and the ELL+tail
   of both hybrid batches; then on empty and overlong rows, and at the
   shapes of the TPU kernels it replaces (G1: one segment of 2^24 entries,
   d=2^22; G2: 2^22 entries, d=2^21; limit ``1e-7 * sum|vals*w|``); the
   chunk kernel (rows of more than 2048 entries) alone at each of its
   launch shapes (the planted transpose in f32 and bf16, the overlong rows,
   G1, G2) against its plain version in f64 (per chunk, 1e-5), with its own
   entries in the kernels line. The launch counter is set to 0 before each
   solve
   and read after it. A small standardized problem (n=4096, d=2^16, ELL and
   column-sorted) solved on the card must agree with the CPU in f64, and
   the card's ELL solve, run twice, must repeat bitwise; so must two sparse
   gradients at the ELL shape (the transpose Xᵀr is the gather's segment
   kernel over a column-sorted plan of the entries, held against its plain
   version at the ELL batch's d=10^7 columns with f32 and bf16 values, and
   on the tails of both hybrid batches; its launches are counted apart from
   the margins' row kernel, and the plan's bytes are printed, its compact
   chunk plan apart).
6. Times (CUDA events, median of 20 after warm-up): per-λ solve times, the
   device time of one sparse evaluation and its parts (the hybrid
   transposes split into the segment kernel and the head), B1 at the wide
   shapes [2^17, 2048] and [2^17, 4099] in f32 and bf16 (held against its
   plain version), and a ``{"kernels": ...}`` JSON line.
7. The GAME slice (``GameEstimator.fit``: a fixed effect plus per-user and
   per-item random effects by coordinate descent), data made with numpy from
   ``--seed``:
   a. the packed-aux kernel's operand forms and units against their plain
      versions at [2^17, 512] and at a ragged shape, twice and bitwise equal,
      with their times (``dev/torch_kernel_probe.py``);
   b. the Newton lanes' Cholesky solve against Gauss-Jordan elimination at
      [2000, 16, 16], with both times;
   c. at bench.py's flagship GAME shape (n=2^17, ``global`` d=256,
      ``per_entity`` d=16, 2000 users, 1500 items, one 128-slot bucket, L2
      weight 1, f32), 4 sweeps each: logistic labels with L-BFGS lanes and
      with Newton lanes, the Newton fit again with the kernel's products on
      the tensor cores (``kernel_unit="mma"``) and through the closed form
      (``use_kernel=False``), bench.py's linear labels with L-BFGS lanes and
      with Newton lanes (the latter through the separate-column form). The
      launch counters are set to 0 before each fit and read after it: every
      fixed-effect evaluation launched the packed kernel. Checks: training
      loss non-increasing over the sweeps; final training losses within rel
      1e-4 (kernel against closed form), 1e-3 (fma against mma; L-BFGS lanes
      against Newton lanes); the logistic model's AUC on 2^15 held-out rows
      (a quarter of unseen users) above the fixed effect's alone;
   d. the kernels on the main path's own inputs at [2^17, 256] against their
      plain versions, with device times, bounds and the two-matmul closed
      form's time;
   e. a small problem (n=4096) on the card in f32 against the CPU in f64:
      coefficients and tables within 1e-3 max|w|;
   f. a larger run (n=2^19, 8,000 users, 6,000 items, logistic, Newton
      lanes, 2 sweeps) whose times are printed.
   The probe study of (a) also runs every variant of the three earliest
   probes (P1-P3: separate columns without offsets or Σr, logistic loss),
   each held against its plain version and timed, with ``STEPS`` gradient
   steps per variant as their launches; the kernels line gains one P1, P2
   and P3 entry.
7b. The projected GAME slice (``PROJECTED``): bench.py's flagship GAME shape
   with the per-user effect on a wider shard, ``per_user_wide`` (d=512,
   column 0 an intercept, each user owning 8-32 of columns 1-511, N(0,1)
   values there), the per-item effect IDENTITY on ``per_entity`` d=16,
   logistic labels from a planted fixed effect, per-user and per-item
   models, 4 sweeps through ``GameEstimator.fit`` with the fixed effect on
   the packed kernel: (a) INDEX_MAP with Newton lanes against IDENTITY over
   the 512 columns (one per-user update of each from the same model and
   residuals: training losses within rel 1e-5; the 4-sweep fits' final
   losses within rel 1e-4; on-support coefficients within 1e-3 max|w|,
   off-support ones exactly 0); (b) INDEX_MAP with
   STANDARDIZATION and full variances (finite and positive on each support,
   NaN off it); (c) RANDOM, projected_dim 64, scaled, L-BFGS lanes, full and
   diagonal variances (finite and positive); (d) INDEX_MAP with
   features_to_samples_ratio 0.25, the kernel's products on the tensor
   cores; (e) on ``per_entity``: Newton, TRON (through the separate-column
   form; final loss within rel 1e-3 of Newton's) and elastic-net OWL-QN
   lanes (L1 0.1). Every fit: training loss non-increasing, held-out AUC
   above the fixed effect's alone, the packed kernel launched on every
   fixed-effect evaluation. Printed: each bucket's bytes, seconds per sweep
   by coordinate, lane iteration histograms, one update's wall and device
   ms, kernels and host reads per lane kind; the packed kernel (P6, P7, P5)
   and its reduce held against their plain versions on this path's own
   fixed-effect inputs (the kernels line's ``projected_path``).
8. The drivers on the card, in a temporary directory (``DRIVERS`` gives the
   row counts; rows are cut, never widths): TrainingExample Avro written with
   the port's writer from ``--seed`` (GAME training and validation sets at
   the flagship widths: a ``global`` bag of 255 features plus the intercept,
   a ``perEntity`` bag of 16 for the per-user and per-item effects; a dense
   GLM set at d=512); the GLM driver (L-BFGS, λ in {1, 10}, validation AUC;
   B1 and its reduction launched once for every evaluation, the text model
   reloads); the GAME training driver (a fixed effect plus per-user and
   per-item Newton lanes, 2 sweeps, two λ values, validation AUC; every
   fixed-effect update launched the packed kernel, once for every
   evaluation, the best model's AUC above its fixed effect's alone); the
   GAME scoring driver on the saved best model (the scores read back from
   its Avro equal the loaded model's in-process scores bitwise, its AUC
   within 1e-4 of the training driver's); the GAME training driver again
   with the per-user effect at ``projector=INDEX_MAP`` and ``reg.alpha`` 0.5
   (elastic-net lanes) and the scoring driver on its model (the same
   checks); then B1 on the GLM driver's batch
   and the packed kernel on the GAME driver's fixed-effect inputs, both read
   back from the Avro, at the trained coefficients: each held against its
   plain version (twice bitwise equal; phase 3's f32 limits) with its
   reduction, and timed (the kernels line's ``driver_path``); the time of
   each stage, records per second of the Avro codec and peak device
   memory. Then the sparse drivers (``SPARSE_DRIVERS``): (i) Avro whose
   ``features`` bag is a name-term bag at phase 9's distribution (rows cut
   to 8,192 + 2,048, users to 250), its index maps from the port's feature
   indexing driver (``--index-maps-dir``), the GAME training driver with a
   fixed effect and a compact per-user effect on that one sparse shard, and
   the scoring driver on its model loaded compact (Avro scores bitwise the
   loaded model's in-process scores); (ii) the GLM driver on LibSVM at
   LIBSVM a1a's widths (123 features, 14 a row, 1,605 rows; validation AUC
   above 0.6); (iii) the GAME training driver on pre-indexed LibSVM at full
   width (d=10^6, 2^16 rows of 16 entries), with the parse's records per
   second. On each GAME run's own data, after its launches are read, G1 is
   held against its plain version (per row 1e-5 Σ|v·w| in f64, twice
   bitwise equal): the training runs' fixed-effect margins and transposes
   (with their chunk plans) on the driver's training batch at its fitted
   coefficients and its compact scores, the scoring run's margins and
   compact scores on the validation rows. Their launches and checks join
   the kernels line's ``driver_path``. Every read of the phase takes the
   port's native Avro decoder (``avro_native.fallbacks`` must stay 0); the
   GAME and GLM validation sets are read again with the Python codec
   (``PHOTON_NO_NATIVE_AVRO=1``) and must give equal arrays, with each
   codec's records per second; a GAME training driver run adds an MF
   coordinate (userId × itemId, k=16) and the scoring driver scores its
   model (Avro scores bitwise the in-process ones); a run with
   ``--input-date-range`` over two daily directories must write the
   one-directory run's model files byte for byte; and one GAME training run
   at the flagship's rows, uncut (2^17 + 2^15), prints its stages, with the
   packed kernel held on its own fixed-effect inputs. The phase's Avro, the
   flagship's and phase 13's are written by a pool of processes running the
   port's pure-Python writer (a part file a task), started after the build
   and writing while phases 3-7b run (``_start_prewrites``).
9. The sparse GAME slice at bench.py:721's shapes (``SPARSE_GAME``, none
   cut): n=2^16 rows of 16 Zipf columns (γ=24) over d=10^6, values
   N(0,1)/4, 2000 users, linear labels, 2^14 held-out rows; a fixed effect
   (L-BFGS, 10 iterations, L2 1) and a per-user random effect on the same
   sparse shard, so compact (``[2000, K]`` over each user's active
   columns). Fits of 4 sweeps: (a) ELL fixed effect and L-BFGS lanes,
   twice (bitwise equal tables and scores); (b) a hybrid fixed effect (a
   256-column head) and Newton lanes; (c) SCALE_WITH_MAX_MAGNITUDE
   (pre-normalized compact blocks) and full variances (finite and positive
   on each support, NaN off it), L-BFGS lanes. Every fit: the training
   loss and the coordinate-descent objective non-increasing; the unscaled
   fits' held-out RMSE below the fixed effect's alone, the scaled fit's
   within 1% of the JAX package's at this size (``SCALED_FIT_REFERENCE``:
   its blocks overfit this data's rare columns there too).
   STANDARDIZATION on the compact effect is refused; a small problem's
   per-user Newton update on the card agrees with the CPU in f64 (1e-3
   max|w|). G1 is held against its plain version in f64 on the phase's own
   inputs (per row 1e-5 Σ|v·w|, twice bitwise equal): the fixed effect's
   margins and transposes (Zipf-hot columns through the chunk kernel) on
   fits a's and b's batches, and compact scoring on fit a's table and
   entries, which is also timed beside cuSPARSE (its own kernels-line
   entry; the path's launches and checks under ``sparse_game_path``). Printed: K and the bucket bytes, the host build
   seconds, seconds a sweep by coordinate, one lane update's wall and
   device ms and kernels.
10. Matrix factorization through ``GameEstimator.fit`` (``MF``), the fixed
   effect on the packed kernel, data from ``--seed``: (a) the flagship
   widths with a user × item MF coordinate (k=16, 2 alternations, L2 10)
   beside the fixed effect and the per-user effect, linear labels with a
   planted rank-16 user·item term, 4 sweeps with Newton MF lanes (twice:
   bitwise equal models), with L-BFGS MF lanes (final loss within rel 1e-3
   of Newton's) and without MF (the products on the tensor cores): training
   loss non-increasing, held-out RMSE (2^15 rows, a quarter of unseen users,
   whose MF scores must be exactly 0) below the fit's without MF; the packed
   kernel and its reduce held on the path's own [2^17, 256] inputs (the
   kernels line's ``mf_path``); (b) MovieLens-1M's published widths, none
   cut (6,040 users with Zipf-like counts of 20-2,314 ratings, 3,706
   movies, 1,000,209 ratings 1-5 from a planted rank-32 model; ``global``
   the one-hot of its attributes, d=49), fixed effect plus MF k=32, Newton,
   4 sweeps: loss non-increasing, held-out RMSE below the fixed effect's
   alone; printed: the MF buckets' shapes and bytes, the host builder's
   seconds, seconds a sweep by coordinate, one half-step's wall and device
   ms, kernels and host reads; (c) one MF update of a small problem (n=4096,
   k=4) from the same factors, card f32 against CPU f64 within
   1e-3·max|factor|.
11. The fused GAME training program (``parallel/distributed.train_distributed``,
   ``FUSED``), data from ``--seed``: (a) the flagship widths (bench.py:542-560,
   none cut, logistic) with a fixed effect (L-BFGS), per-user and per-item
   effects (AUTO lanes, which resolve to Newton) and phase 10's MF
   coordinate (k=16, 2 alternations, L2 10), 4 fused sweeps: per sweep its
   seconds, training loss, block coordinate descent's objective (both
   non-increasing), the fixed effect's evaluations and B1's launches (one
   per evaluation); one sweep under ``torch.profiler`` (wall and device ms,
   kernels, the device's idle share); ``GameEstimator.fit`` of the same
   model on the same data, its seconds a sweep beside the fused ones;
   held-out AUC (2^15 rows, a quarter of unseen users) above the fixed
   effect's alone; the state through ``state_to_game_model``, model I/O and
   ``game_model_to_state`` back bitwise, and a warm-started sweep from it;
   B1 and its reduce held against their plain versions on the fused step's
   own fixed-effect batch (the trained coefficients, the residual offsets),
   twice bitwise, at phase 3's f32 limits. (b) Phase 9's shapes (n=2^16 rows
   of 16 Zipf columns over d=10^6, 2000 users, linear): a sparse fixed effect
   with a compact per-user effect on the same shard, and with an INDEX_MAP
   per-user effect on a dense [2^16, 16] shard half zero (the dry run's
   second program at full width), 4 sweeps each, the objective
   non-increasing; G1's rows, chunks and segments (the fixed effect's
   margins and transposes) and compact scoring held against their plain
   versions on each program's own inputs (per row 1e-5·Σ|v·w| in f64, twice
   bitwise). (c) A small fused sweep (n=4096, fixed + per-user + MF k=4)
   from the same state on the card in f32 and on the CPU in f64: the whole
   state within 1e-3·max|w|. The launches and checks join the kernels
   line's ``fused_path``.
12. The fused program over a data-axis mesh (``torch.distributed``, phase
   11's flagship data, none cut): (a) a one-rank NCCL group, 4 sweeps held
   against the same sweeps with ``mesh=None`` (state within 1e-4·max|w|,
   loss 1e-5 rel; whether bitwise is printed), per sweep its seconds, loss,
   objective, FE evaluations, B1 launches and collectives with their bytes,
   one profiled sweep, and B1 and its reduce on the rank's own block; (b)
   two ranks, NCCL over two cards where there are two, else two processes
   on the one card over gloo with CUDA tensors: the state within
   1e-3·max|w| of (a) (the f32 sums change order), two runs bitwise, B1 on
   rank 0's block; (c) ``GameTransformer(mesh=...)`` on the 2^15 held-out
   rows within 1e-5 rel of the one-device transform, the device AUC within
   1e-6 of the host's and above the fixed effect's; phase 11's sparse
   program over the one-rank mesh (G1's rows, segments, chunks and compact
   scoring held on its own inputs); (d) the GAME training and scoring
   drivers with and without ``--distributed`` on the flagship's Avro cut
   to a quarter of its rows (``FLAGSHIP_AVRO["cut"]``: 2^15 + 2^13 rows,
   the widths, users and items kept; 16 training parts clustered by user):
   index maps, metadata and id-info byte-identical, coefficients within
   1e-3·max|w|, the written scores bitwise the in-process ones. The
   launches and checks join the kernels line's ``mesh_path``. Phases 13,
   14(e), 17(e) and 18(b) read the same cut Avro.
13. Partitioned I/O (``io/partitioned_reader.py``, ``train_partitioned``):
   one NCCL rank, whose partitioned read is the full read, trains bit for bit
   as the full read's ``train_distributed(mesh=)``; then two ranks on the
   card (gloo with CUDA tensors), each decoding about half of every input
   (bytes, seconds and records/s per rank against the full read printed):
   (a) the flagship Avro, FE + per-user 4 sweeps within 1e-3·max|w| and
   1e-5 rel loss of the full read, twice bitwise, then FE + per-user +
   per-item with the items spanning the ranks (gap printed, no bound); (b)
   phase 9's sparse shape as Avro with a dense 16-wide per-user shard, an ELL
   and then a hybrid (256-column head) fixed effect: the agreed ELL width,
   flat block and hot ids the full read's, the state within 1e-3·max|w|;
   (c) two held-out part files as one container (blocks mode, the Python codec)
   array for array the files mode's; (d) ``score_partitioned`` of the 2^13
   held-out rows, the ranks' rows bitwise the one-rank scorer's; (e) the
   GAME drivers with ``--partitioned-io --distributed`` on two ranks:
   index maps, metadata and id-info byte-identical to ``--distributed``'s,
   coefficients within 1e-3·max|w|, the two score parts exactly the
   one-rank scores. B1 and its reduce, and G1's rows, chunks and segments,
   held on rank 0's own partitioned blocks, join the kernels line's
   ``partitioned_path``. The flagship Avro is the cut one of phase 12(d);
   the two ranks run (a)-(d) and (e) in one process group.
14. The model axis (``parallel/column_sharded.py``, ``fe_feature_sharded``),
   ranks spawned on the card (gloo with CUDA tensors; NCCL with a card a rank
   where there are as many cards): (a) a one-rank NCCL mesh data=1, model=1
   with ``fe_feature_sharded``, phase 12(a)'s run bit for bit; (b) phase 5's
   ELL (n=2^19, d=10^7, 36 entries a row, logistic: L-BFGS at λ=1, then
   TRON) and hybrid d=10^8 TRON (n=2^18, 5·10^7 coefficients a rank), the
   coefficient axis over model=2, each solve twice bitwise, within
   1e-3·max|w| of phase 5's one-device solves, every rank's values equal,
   each rank's coefficient, gradient and history bytes, seconds,
   evaluations and collectives printed; G1's partial margins, segment
   transpose and long columns' chunks held on rank 0's column block against
   their plain versions with times and bounds; (c) phase 11's flagship (4
   sweeps) with the fixed effect feature-sharded at data=1, model=2 and
   data=2, model=2: state within 1e-3·max|w| and the final loss 1e-5 rel of
   phase 12(a)'s mesh=None run, two runs bitwise, every rank's per-step values
   equal, seconds a sweep, collectives per axis and one profiled sweep;
   phase 9's sparse GAME shape with its fixed effect feature-sharded at 1x2;
   (d) ``DistributedScorer(fe_feature_sharded=True)`` on the 2^15 held-out
   rows within 1e-5 rel of the one-device transform; (e) both GAME drivers
   with ``--mesh data=1,model=2`` on phase 12(d)'s cut flagship Avro
   against phase 12(d)'s ``--distributed`` run: index maps, metadata and
   id-info byte-identical, coefficients within 1e-3·max|w|, the written
   scores bitwise the in-process feature-sharded ones. (b), (c) at 1x2 and
   (e) run in one process group of two ranks. The launches and checks join
   the kernels line's ``model_path``.
15. Streamed GLM solves, checkpoints and recovery (``STREAM``): (a) phase 4's
   generator's ``[n, 512]`` logistic problem at n=2^17 (half phase 4's rows,
   cut for the script's time), in 4 chunks of 2^15 rows
   (``ArrayChunkSource``, standardization from ``streaming_summarize``): an
   L-BFGS λ path {1, 10} (again with prefetch off at λ=1), a TRON solve and
   L-BFGS at λ=1 cut at 5 iterations, streamed and in core: where both run
   their budget the same
   iterations and coefficients within 1e-4·max|w|; where a stopping test
   fires at the objective's f32 resolution, final values within 1e-6 rel and
   iterations at most one apart; one streamed evaluation within f32 rounding
   of the in-core one (value 1e-5 rel, gradient 1e-4·max|g|), prefetch on
   and off bitwise, B1 and its reduce launched once a chunk an evaluation and
   held against their plain versions on one chunk; an epoch split into
   decode, wait, copy and accumulation, with the bytes copied; (b) phase 5's
   ELL in 4 chunks of 2^17 rows (``SparseArrayChunkSource``), L-BFGS at λ=1
   for 20 iterations within 1e-3·max|w| of phase 5's in-core solve, G1's
   launches a chunk, the chunk's transpose plan rebuilt, G1 held on one
   chunk's margins and transpose; (c) a transient ``OSError(EIO)`` mid-epoch
   in (a)'s second λ through ``run_with_recovery`` and a ``SolverCheckpointer``
   (bitwise (a)'s models, one restore), (b)'s solver saves every 5 iterations
   (bytes and seconds), phase 7's flagship ``GameEstimator.fit`` stopped after
   update 5 and resumed, phase 11's flagship with MF through a one-rank NCCL
   ``train_distributed`` resumed from sweep 2 (both bitwise), a sticky CUDA
   error not retried; (d) the GLM driver with ``--streaming-chunks`` on 128
   of phase 8's rows against in core (1e-3 rel; prefetch on and off
   byte-identical models) with the Python codec's stream decode rate, and the
   GAME driver with ``--checkpoint-dir`` run twice (byte-identical models).
   The launches and checks join the kernels line's ``stream_path``.
16. Streamed GAME, two ranks and coordinated recovery (``STREAM_GAME``): (a)
   the flagship in memory at half its rows (2^16 rows, ``[2^16, 256]`` f32,
   16 per-user features, 2000 users; entity-sorted) in user-clustered chunks
   of about
   2^14 rows (``GameArrayChunkSource``), FE + per-user (the flagship's items
   span any user-clustered chunking): 4 sweeps at bench.py's budgets (L-BFGS
   10 and 10), the sweep's split (FE decode, wait, copy, accumulation; RE
   loads and chunk solves), B1 launched once a chunk a value+gradient epoch
   and held with its reduce against the plain versions on one GAME chunk; at
   budgets of 2 and 2 iterations ``schedule=None`` twice and the uniform
   schedule bitwise equal, and against ``GameEstimator.fit`` (the packed
   kernel held on that fit's fixed effect): both coordinates within
   1e-4·max|w| after one sweep, the fixed effect after four, the losses
   within 1e-6 rel, and in f64 both coordinates after four;
   (b) DuHL (working set 3, tail 1) against uniform to a loss tolerance:
   chunk loads, seconds and the pinned cache's host bytes; (c) two ranks
   sharing the card (gloo, a CUDA context each), each streaming its run of
   the in-memory flagship's chunks over the key-value exchange, in f32 and
   f64 against (a)'s one-rank runs (both ranks bitwise equal, the f64 run
   within 1e-4·max|w|), and over the flagship's rows of its first users as
   user-clustered Avro through ``plan_partitioned_game_stream``: both
   ranks' state bitwise equal and within 1e-4·max|w| of one rank's streamed
   run, the exchange's operations and bytes a sweep; (d) rank 1 killed at the
   sweep-2 commit barrier (the streamed run, then ``train_partitioned``):
   every rank rolled back bitwise to the uninterrupted end, rank 0's
   ``PeerAbort`` naming rank 1, the seconds from the fault to the resumed
   sweep; a sticky CUDA error on rank 1 retried on no rank; (e) the GAME
   driver with ``--streaming-chunks`` and with ``--duhl-working-set`` against
   the in-core driver (1e-3·max|w|), its validation through
   ``score_game_stream`` within 1e-5 rel of the in-core scoring. The Avro
   runs are cut in depth (the Python codec decodes every chunk each epoch).
   The launches and checks join the kernels line's ``stream_game_path``.
17. Serving (``SERVING``; ``photon_ml_torch/serving``, ``cli/serve_driver``):
   (a) phase 11's flagship (two fused sweeps) resident on the card, its 2^15
   held-out rows (a quarter of unseen users) served one row a request through
   ``MicroBatchServer`` on shapes (64, 256, 1024), one captured CUDA graph a
   signature: each bucket's graph bitwise ``score_dataset`` of the same
   padded bucket, the served scores within 1e-6·max|score| of the unpadded
   eager scores, every request resolved, no capture in the replay; scores/s
   batched and one request a micro-batch, latency p50/p95, the pad fraction;
   (b) phase 9's sparse GAME models (the ELL fit and the hybrid fit, one
   sweep) served the same way, with 32 requests of 4096 entries (the row
   and chunk kernels): each graph replayed twice bitwise and held against the
   plain program in f64 on its own padded inputs, G1's row and segment
   kernels and the chunk kernel called on those inputs against the plain
   gather in f64 (1e-5·Σ|v·w| a row); every served request within
   1e-5·Σ|terms| of the eager ``DistributedScorer.score_dataset`` of the
   same rows unpadded (its own device assembly of the entries and plans);
   each bucket's graph bitwise ``score_dataset`` of the same padded bucket on
   every row both programs gather with the same kernel and plan (the one row
   the entry pads can make long is held to 1e-5·Σ|terms| and counted); one
   replay of each signature under ``torch.profiler``, the gather kernels it
   shows by name equal to the launches the graph counts; (c) an equal-layout swap halfway
   through (a)'s replay (no capture; before it the old model's scores, after
   it the new one's) and a layout-changing swap refused with the old scores
   kept bitwise; (d) (a) in bf16 (the gap printed); (e) the serve driver on
   phase 8's flagship-width validation Avro with ``--swap-model-dir`` (phase
   12(d)'s models), and the resident scores against the scoring driver's.
   (b)'s launches, checks and traced replays join the kernels line's
   ``serving_path``.
18. Search and scheduling (``SEARCH``; ``algorithm/lane_scheduler.py``,
   ``algorithm/refresh.py``, ``algorithm/lane_search.py``,
   ``hyperparameter/``): (a) phase 7's flagship (logistic, L-BFGS lanes of
   20 iterations with a live function stop at 1e-6, 4 sweeps, f32) through
   ``GameEstimator.fit`` unscheduled, with probe/rescue (probe 2) and with
   freezing as well: no run's loss rises, the scheduled final losses' gaps
   printed, lanes frozen in sweep 2 and skipped in sweep 3 with their rows
   bitwise kept and the active set reset after the final sweep, a fit with
   ``scheduler=None`` bitwise a fit built without the field; lanes probed,
   rescued and frozen and the rescue blocks per sweep, seconds a sweep, one
   profiled per-user update of each; P6 held on the scheduled fit's fixed
   effect. Then in f64 (the closed-form fixed effect), the lanes run to a
   1e-10 function stop: probe/rescue's final loss within 1e-5 rel of the
   unscheduled one. (b) ``train_distributed``
   of a scheduled per-user program on one device and ``train_partitioned``
   with ``schedulers=`` on two gloo ranks at phase 13's flagship (the ranks'
   losses equal, the state within 1e-3·max|w| of one device; B1 and its
   reduce held on the step's fixed effect). (c) ``GameEstimator.refresh`` of
   (a)'s unscheduled model after the labels of 100 users are redrawn:
   unselected rows bitwise, the declared users selected, the loss on the new
   data not above the resident model's, a stopped-and-resumed refresh bitwise
   the whole one, a checkpoint under another λ refused; seconds against a
   4-sweep fit. (d) λ-grid lanes: phase 4's dense problem, 8 λ over
   [1e-2, 1e2] at 20 iterations and to the stopping tests against cold
   ``train_glm`` solves, an elastic-net grid and diagonal variances; phase
   5's ELL, 4 λ at 20 iterations, scaled and unscaled, G1's row and segment
   launches equal to lanes × evaluations, G1 held on the scaled lanes' inputs
   in f64, each unscaled lane within 1e-3·max|w| of ``train_glm``, and each
   scaled lane, run in f64 on the plain gathers, too. (e) a uniform
   tournament bitwise the grid; ``run_model_search`` (GP, 3 rounds × 8 lanes,
   AUC on 2^16 held-out rows on the device); the GLM driver with
   ``--grid-parallel`` (against its cold sequential runs) and
   ``--search-rounds 2``; the GAME driver with ``--hyperparameter-tuning
   BAYESIAN`` and ``--incremental-refresh`` on phase 8's cut rows. (f) phase
   16(a)'s streamed flagship, per-user scheduled against unscheduled, 2
   sweeps: final losses within 1e-5 rel. Its launches and checks join the
   kernels line's ``search_path``.
19. Telemetry and diagnostics (``TELEMETRY``; ``diagnostics/``,
   ``telemetry/``, the drivers' item-19 flags): (a) phase 4's generator and
   widths (2^18 + 2^16 rows, d=512, standardized), the diagnostic report of
   the better of λ ∈ {1, 10} with 8 bootstraps and the 5 default fitting
   portions: its seconds, refits, the Hosmer-Lemeshow statistic, Kendall's
   tau and the unstable coefficients; B1's launches equal to the refits'
   evaluations, exactly; B1 held on a bootstrap's reweighted batch. (b) the
   same report at 2^14 rows with 4 bootstraps, standardized and solved to
   convergence, on the card in f32 against the CPU in f64: every refit's
   coefficients within 1e-3·max|w| and every metric of the report within
   1e-4. (c) the GLM driver on phase 8's GLM Avro with
   ``--enable-diagnostics --num-bootstraps 4 --telemetry-dir --trace-dir``
   against the run without them: the report files, the journal read back,
   the training phase's ``solver/iteration`` spans equal to the journal's
   iterations, the model files bitwise. (d) the GAME training driver on the
   flagship's cut Avro, 2 sweeps: plain, with ``--telemetry-dir
   --trace-dir``, plain again and with ``--profile-dir`` too: the model
   files bitwise, the lane loops' host reads equal, the profiler's
   ``packed_glm_partials_kernel`` events equal to the launch counter, the
   seconds against the warm plain run; P6 held on the driver's fixed
   effect. (e) the scoring driver with and without telemetry (scores
   bitwise) and the serve driver with it (its counters in the journal). (f)
   phase 13(e)'s training driver runs with ``--trace-dir --telemetry-dir``:
   a trace file a rank, and the straggler report naming every exchange tag
   either trace waited on. Its launches and checks join the kernels line's
   ``telemetry_path``.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import errno
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): memory rate, f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


_T0 = time.perf_counter()


def _log(msg: str) -> None:
    """``msg`` on standard output; its start, after the seconds since the
    script began, on standard error (where the time of each step reads)."""
    print(msg, flush=True)
    print(f"[{time.perf_counter() - _T0:8.1f} s] {msg[:100]}", file=sys.stderr, flush=True)


#: what the fork server of ``_processes`` imports once, before any fork
_PRELOAD = ("__main__", "numpy", "torch", "photon_ml_torch.io.avro",
            "photon_ml_torch.parallel.distributed", "photon_ml_torch.parallel.multihost",
            "photon_ml_torch.parallel.column_sharded", "photon_ml_torch.parallel.scoring",
            "photon_ml_torch.algorithm.streaming_game", "photon_ml_torch.estimators",
            "photon_ml_torch.cli.game_training_driver", "photon_ml_torch.cli.game_scoring_driver")


def _processes():
    """The multiprocessing context of every process the script starts (the
    ranks and the Avro writers): a fork server, started once, that imported
    ``_PRELOAD`` (torch and the port's modules, no CUDA context), so a
    process starts in milliseconds instead of importing them again (about
    5 s of host time a process)."""
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(_PRELOAD))
    return ctx


def _eager_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call as the solver loop makes it: the
    device work plus any host-side launch overhead it cannot hide."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def _device_ms(torch, fn, reps: int = 20, calls: int = 10) -> float:
    """Median device time of one call: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events, so no host
    overhead is in the time."""
    fn()  # warm up outside the capture (kernel build, grid query)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    del graph
    return statistics.median(times)


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _kernel_cases(torch, fused_glm, losses, LabeledPointBatch, NormalizationContext, seed):
    """Phase 3: every loss x dtype x normalization at the main shape plus the
    ragged and wide shapes. Returns the worst errors seen."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"value_rel": 0.0, "grad_rel_to_max": 0.0, "main_grad_abs": 0.0, "cases": 0}
    shapes = [(1 << 18, 512, ("NONE", "SCALE", "STANDARDIZATION")),
              (1000, 123, ("STANDARDIZATION",)),
              (1001, 4099, ("STANDARDIZATION",)),
              (4096, 8192, ("STANDARDIZATION",)),
              (4096, 8200, ("STANDARDIZATION",))]
    for n, d, norms in shapes:
        x = torch.randn(n, d, device=dev, generator=gen)
        y_bin = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
        y_real = torch.rand(n, device=dev, generator=gen) * 3.0
        offsets = 0.1 * torch.randn(n, device=dev, generator=gen)
        weights = 0.2 + 1.8 * torch.rand(n, device=dev, generator=gen)
        weights[::5] = 0.0
        w = torch.randn(d, device=dev, generator=gen) * 0.3 / (d / 16) ** 0.5
        factors = 0.5 + 1.5 * torch.rand(d, device=dev, generator=gen)
        factors[-1] = 1.0
        shifts = 0.1 * torch.randn(d, device=dev, generator=gen)
        shifts[-1] = 0.0
        contexts = {"NONE": None, "SCALE": NormalizationContext(factors, None),
                    "STANDARDIZATION": NormalizationContext(factors, shifts)}
        for dtype in (torch.float32, torch.bfloat16):
            for name in ("LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"):
                loss = getattr(losses, name)()
                y = y_bin if name in ("LogisticLoss", "SmoothedHingeLoss") else y_real
                batch = LabeledPointBatch.create(x, y, offsets, weights, dtype=dtype, device=dev)
                for norm in norms:
                    kw = dict(l2_weight=0.5, normalization=contexts[norm])
                    v1, g1 = fused_glm.fused_value_and_gradient(loss, w, batch, **kw)
                    v2, g2 = fused_glm.fused_value_and_gradient(loss, w, batch, **kw)
                    vr, gr = fused_glm.fused_value_and_gradient_reference(loss, w, batch, **kw)
                    torch.cuda.synchronize()
                    tag = f"{name} {str(dtype)[6:]} {norm} n={n} d={d}"
                    assert torch.equal(v1, v2) and torch.equal(g1, g2), f"not bitwise: {tag}"
                    assert bool(torch.isfinite(v1)) and bool(torch.isfinite(g1).all()), tag
                    value_rel = abs(float(v1 - vr)) / max(abs(float(vr)), 1e-30)
                    gmax = float(gr.abs().max())
                    grad_abs = float((g1 - gr).abs().max())
                    # f32 value rel 1e-5; bf16 (same bf16 inputs on both
                    # sides) 1e-4; gradient rtol 1e-4, atol 1e-4 * max|g|
                    vtol = 1e-5 if dtype == torch.float32 else 1e-4
                    assert value_rel <= vtol, f"value {value_rel} > {vtol}: {tag}"
                    assert torch.allclose(g1, gr, rtol=1e-4, atol=1e-4 * gmax), \
                        f"gradient off by {grad_abs} (max |g| {gmax}): {tag}"
                    worst["value_rel"] = max(worst["value_rel"], value_rel)
                    worst["grad_rel_to_max"] = max(worst["grad_rel_to_max"], grad_abs / gmax)
                    if (n, d, dtype, name, norm) == (1 << 18, 512, torch.float32,
                                                      "LogisticLoss", "STANDARDIZATION"):
                        worst["main_grad_abs"] = grad_abs
                    worst["cases"] += 1
        del x, batch
    return worst


def _wide_b1_entries(torch, fused_glm, loss, seed: int, card: str) -> list:
    """B1 at the wide shapes (n=2^17, d=2048 and a ragged 4099; f32 and
    bf16; bf16 at 2048 is the width at which a GAME fixed effect falls back
    from the packed kernel to B1): the kernel twice (bitwise equal) against
    its plain version within phase 3's limits, its plan, and its time
    beside the bound, the plain version's and the two products ``X@w``,
    ``r'X`` in X's dtype. No path of this run solves at these widths, so
    ``launches`` is 0."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    n = 1 << 17
    entries = []
    for d in (2048, 4099):
        x32 = torch.randn(n, d, device=dev, generator=gen)
        y = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
        o = 0.1 * torch.randn(n, device=dev, generator=gen)
        ws = 0.2 + 1.8 * torch.rand(n, device=dev, generator=gen)
        w = 0.3 * torch.randn(d, device=dev, generator=gen) / (d / 16) ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)

            def kernel():
                return fused_glm.reduce_partials(*fused_glm.fused_partials(loss, x, y, o, ws, w))

            v1, g1, _ = kernel()
            v2, g2, _ = kernel()
            vr, gr, _ = fused_glm._plain_core(loss, x, y, o, ws, w, None)
            torch.cuda.synchronize()
            tag = f"B1 [{n}, {d}] {str(dtype)[6:]}"
            assert torch.equal(v1, v2) and torch.equal(g1, g2), f"not bitwise: {tag}"
            vtol = 1e-5 if dtype == torch.float32 else 1e-4
            assert abs(float(v1 - vr)) <= vtol * abs(float(vr)), tag
            gmax = float(gr.abs().max())
            assert torch.allclose(g1, gr, rtol=1e-4, atol=1e-4 * gmax), tag
            nbytes = n * d * x.element_size() + 12 * n + 4 * d + 4 * d + 8
            bound, by = _bound_ms(nbytes, 4.0 * n * d)
            wx, r = w.to(dtype), ws.to(dtype)
            plan = fused_glm.tile_plan(d, dtype)
            entry = {
                "name": "fused_glm", "route": "cuda",
                "source": "photon_ml_torch/csrc/fused_glm.cu",
                "replaces": "photon_ml_tpu/ops/pallas_glm.py:128", "launches": 0,
                "max_abs_err": float((g1 - gr).abs().max()),
                "ms": _device_ms(torch, kernel),
                "plain_ms": _device_ms(torch, lambda: fused_glm._plain_core(
                    loss, x, y, o, ws, w, None)),
                "bound_ms": bound, "bound_by": by,
                "library_ms": _device_ms(torch, lambda: (torch.matmul(x, wx),
                                                         torch.matmul(r, x))),
                "shape": [n, d], "dtype": str(dtype)[6:], "on_main_path": False,
                "plan": [plan.rows, plan.stages, plan.phases, plan.vectors]}
            _log(f"{tag} ({card}): {entry['ms']:.4f} ms (bound {bound:.4f}, plain "
                 f"{entry['plain_ms']:.4f}, X@w + r'X {entry['library_ms']:.4f}), plan "
                 f"{plan}, max |dg| {entry['max_abs_err']:.3g} of max |g| {gmax:.3g}")
            entries.append(entry)
            del x
        del x32
    torch.cuda.empty_cache()
    return entries


def _dataset(np, seed: int, n: int, d: int):
    """f32 logistic data: shifted/scaled columns, the last one a constant-1
    intercept (STANDARDIZATION needs it), labels from a planted model."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= rng.uniform(0.5, 3.0, size=d).astype(np.float32)
    x += rng.normal(size=d).astype(np.float32)
    x[:, -1] = 1.0
    w_true = (rng.normal(size=d) * 2.0 / np.sqrt(d)).astype(np.float32)
    z = (x - x.mean(axis=0)) @ w_true
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return x, y


#: shapes of the sparse slice: bench.py's giant-FE rows (bench_sparse_fe,
#: bench_sparse_fe_hybrid, bench_sparse_fe_1e8), the TPU kernels' probe
#: shapes (G1, G2), ragged rows, and the card-against-CPU problem
SPARSE = {
    "ell": dict(n=1 << 19, d=10_000_000, per_row=32, held_out=1 << 16),
    "hybrid": dict(n=1 << 19, d=10_000_000, per_row=32, hot_cols=256),
    "hybrid_1e8": dict(n=1 << 18, d=100_000_000, per_row=16, hot_cols=512),
    "ragged": dict(n=1 << 16, d=1_000_000, width=16),
    "g1": dict(nnz=1 << 24, d=1 << 22),
    "g2": dict(nnz=1 << 22, d=1 << 21),
    "small": dict(n=4096, d=1 << 16, per_row=16),
}


def _zipf_cols(np, rng, size: int, d: int, gamma: float = 24.0):
    """bench.py's ``_zipf_cols``: bounded power-law column ids (the top k
    columns hold a (k/d)^(1/gamma) share of the entries), scattered over
    [0, d) by an odd multiplicative bijection."""
    raw = (rng.random(size) ** gamma * d).astype(np.int64)
    return (raw * 2654435761) % d


def _planted_ell_data(np, seed: int, n: int, d: int, per_row: int, held_out: int):
    """bench.py's d=10^7 data (bench_sparse_fe): per row ``per_row`` uniform
    columns plus 4 columns of a 256-column planted support, f32 values,
    logistic labels drawn from the planted model. Returns the COO and labels
    of ``n`` training rows and of ``held_out`` more rows of the same model."""
    rows, cols, vals, y = _planted_rows(np, seed, n + held_out, d, per_row)
    train = rows < n
    held = ~train
    return (rows[train], cols[train], vals[train], y[:n]), \
        (rows[held] - n, cols[held], vals[held], y[n:])


def _planted_rows(np, seed: int, n: int, d: int, per_row: int):
    rng = np.random.default_rng(seed + 3)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, d, size=n * per_row)
    vals = rng.normal(size=n * per_row).astype(np.float32)
    support = rng.choice(d, size=256, replace=False)
    w_true = rng.normal(size=256).astype(np.float32)
    sig = rng.integers(0, 256, size=(n, 4))
    sig_vals = rng.normal(size=(n, 4)).astype(np.float32)
    logits = (sig_vals * w_true[sig]).sum(axis=1)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    rows = np.concatenate([rows, np.repeat(np.arange(n), 4)])
    cols = np.concatenate([cols, support[sig].ravel()])
    vals = np.concatenate([vals, sig_vals.ravel()])
    return rows, cols, vals, y


def _zipf_data(np, seed: int, n: int, d: int, per_row: int):
    """bench.py's hybrid data: ``per_row`` Zipf columns per row, f32 values,
    coin-flip labels."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = _zipf_cols(np, rng, n * per_row, d)
    vals = rng.normal(size=n * per_row).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return rows, cols, vals, y


def _gather_check(torch, tag: str, w, n: int, ell=None, tail=None, chunks=None,
                  rel: float = 1e-5) -> dict:
    """The gather kernel, called twice (bitwise equal), against its plain
    version on the same inputs, evaluated in f64 (the bf16 and f32 values
    widen exactly): per row |k - p| <= rel * sum|vals * w| + 1e-30.

    rel is 1e-5 for rows of the batch layouts. The one-segment cases pass
    1e-7: at G1's shape (2^24 products of two standard normals, sum|vals*w|
    about 1.07e7) that is about 1.1, where the sum of one 2048-entry chunk
    is typically about 45, so a lost or doubled chunk fails."""
    from photon_ml_torch.ops import sparse_gather

    k1 = sparse_gather.gather_sum(w, n, ell=ell, tail=tail, chunks=chunks)
    k2 = sparse_gather.gather_sum(w, n, ell=ell, tail=tail, chunks=chunks)

    def wide(part, fn=lambda v: v):
        return None if part is None else (fn(part[0].double()), *part[1:])

    plain = sparse_gather.gather_sum_reference(w.double(), n, ell=wide(ell), tail=wide(tail))
    scale = sparse_gather.gather_sum_reference(w.abs().double(), n, ell=wide(ell, torch.abs),
                                               tail=wide(tail, torch.abs))
    torch.cuda.synchronize()
    assert torch.equal(k1, k2), f"gather kernel not bitwise repeatable: {tag}"
    assert k1.dtype == torch.float32 and bool(torch.isfinite(k1).all()), tag
    err = (k1.double() - plain).abs()
    bad = int((err > rel * scale + 1e-30).sum())
    assert bad == 0, f"gather kernel off its plain version in {bad} of {n} rows: {tag}"
    return {"case": tag, "rows": n, "rel_limit": rel, "max_abs_err": float(err.max()),
            "max_err_over_scale": float((err / (scale + 1e-30)).max())}


def _gather_entry(torch, replaces: str, w, n: int, check: dict, ell=None, tail=None,
                  chunks=None) -> dict:
    """One ``sparse_gather`` entry of the kernels line: device and eager
    time, the plain version's, one PyTorch call of the same function
    (``library_ms``: for ELL rows a cuSPARSE CSR product of the same
    entries, built outside the timing; for one segment ``torch.dot`` of the
    values with ``w`` gathered at their columns, which ``dot_ms`` also times
    for ELL rows as one sum), the worst row error as a share of its limit,
    and the bound from the
    bytes these inputs need (every stored entry, the outputs, the row
    pointers and each distinct column of w once) and 2 f32 operations per
    entry."""
    from photon_ml_torch.ops import sparse_gather

    vals, cols = ell if ell is not None else tail[:2]
    stored = vals.numel()
    nbytes = stored * (vals.element_size() + 4) + 4 * n
    nbytes += 4 * int(torch.unique(cols).numel())
    if tail is not None:
        nbytes += 4 * (n + 1)
        if chunks is not None:
            nbytes += chunks.nbytes()
    bound, by = _bound_ms(nbytes, 2.0 * stored)
    w_lib = w.to(vals.dtype)
    flat_vals, flat_cols = vals.reshape(-1), cols.reshape(-1).long()
    # the same gathers summed into one number (G1's one-segment yardstick)
    dot = lambda: torch.dot(flat_vals, w_lib[flat_cols])  # noqa: E731
    if ell is not None:
        crow = torch.arange(n + 1, dtype=torch.int32, device=vals.device) * vals.shape[1]
        csr = torch.sparse_csr_tensor(crow, cols.reshape(-1), flat_vals,
                                      (n, w.shape[0]), check_invariants=False)
        library = lambda: csr @ w_lib  # noqa: E731
    else:
        assert n == 1, "the library call times one segment"
        library = dot

    def kernel():
        return sparse_gather.gather_sum(w, n, ell=ell, tail=tail, chunks=chunks)

    return {"name": "sparse_gather", "route": "cuda",
            "source": "photon_ml_torch/csrc/sparse_gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": check["max_abs_err"],
            "ms": _device_ms(torch, kernel), "eager_ms": _eager_ms(torch, kernel),
            # fewer repeats: the plain version's one-segment index_add_ (every
            # entry's atomic add lands on one slot) takes milliseconds at G1's shape
            "plain_ms": _device_ms(torch, lambda: sparse_gather.gather_sum_reference(
                w, n, ell=ell, tail=tail), reps=5, calls=2),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _device_ms(torch, library, reps=5, calls=2),
            "dot_ms": _device_ms(torch, dot, reps=5, calls=2),
            "worst_err_share_of_limit": check["max_err_over_scale"] / check["rel_limit"],
            "shape": [n, vals.shape[1]] if ell is not None else [n, stored],
            "layout": "ell" if ell is not None else "one segment",
            "dtype": str(vals.dtype).replace("torch.", ""), "d": int(w.shape[0]),
            "bytes": nbytes}


def _transpose_entry(torch, replaces: str, r, d: int, check: dict, plan, layout: str,
                     **extra) -> dict:
    """The ``sparse_gather`` entry of the gradient's transpose: the segment
    kernel over a batch's column-sorted plan (segments: the d columns;
    gathered: ``r`` at each entry's row). ``library_ms`` is cuSPARSE's
    product of the same entries as a CSR ``[d, n]`` matrix with ``r`` (bf16
    values widened to f32 first, outside the timing: the same function; its
    product with a bf16 ``r``, which rounds r, is ``library_bf16_r_ms``).
    The bound counts what the function needs: each entry, the column
    pointers, the output and each distinct row of ``r`` once (not the chunk
    plan, which only this kernel reads), and 2 operations per entry. The
    plain version's column ids are rebuilt from the pointers outside its
    timing."""
    from photon_ml_torch.ops import sparse_gather

    vals, rows, col_ptr, chunks = plan
    cols = sparse_gather.segment_ids(col_ptr)
    stored = vals.numel()
    nbytes = stored * (vals.element_size() + 4) + 4 * d + 4 * (d + 1)
    nbytes += 4 * int(torch.unique(rows).numel())
    bound, by = _bound_ms(nbytes, 2.0 * stored)
    csr = torch.sparse_csr_tensor(col_ptr, rows, vals.float(), (d, r.shape[0]),
                                  check_invariants=False)
    if vals.dtype != torch.float32:
        csr_16 = torch.sparse_csr_tensor(col_ptr, rows, vals, (d, r.shape[0]),
                                         check_invariants=False)
        r_16 = r.to(vals.dtype)
        extra["library_bf16_r_ms"] = _device_ms(torch, lambda: csr_16 @ r_16)

    def kernel():
        return sparse_gather.gather_sum(r, d, tail=(vals, rows, None, col_ptr), chunks=chunks)

    return {"name": "sparse_gather", "route": "cuda",
            "source": "photon_ml_torch/csrc/sparse_gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": check["max_abs_err"],
            "ms": _device_ms(torch, kernel), "eager_ms": _eager_ms(torch, kernel),
            "plain_ms": _device_ms(torch, lambda: sparse_gather.gather_sum_reference(
                r, d, tail=(vals, rows, cols, col_ptr))),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _device_ms(torch, lambda: csr @ r),
            "worst_err_share_of_limit": check["max_err_over_scale"] / check["rel_limit"],
            "shape": [d, stored], "layout": f"transpose (column-sorted plan), {layout}",
            "dtype": str(vals.dtype).replace("torch.", ""), "chunks": None if chunks is None
            else chunks.count, "bytes": nbytes, **extra}


def _chunk_csr(torch, tail, chunks, width: int):
    """The chunk kernel's function as one CSR matrix ``[chunks.count,
    width]`` and the tail positions of its entries: the long rows' entries
    copied in order into contiguous arrays (bf16 values widened to f32),
    one matrix row a chunk of the plan, so ``csr @ w`` is cuSPARSE's
    per-chunk partials. Built once, outside any timing."""
    from photon_ml_torch.ops import sparse_gather

    vals, cols, _, row_ptr = tail
    dev = vals.device
    rows = chunks.rows.long()
    starts, lens = row_ptr[rows].long(), (row_ptr[rows + 1] - row_ptr[rows]).long()
    offsets = torch.cumsum(lens, 0) - lens  # each long row's start in the copy
    of = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), lens)
    entry = starts[of] + torch.arange(of.numel(), device=dev) - offsets[of]
    first = chunks.chunk_ptr[:-1].long()
    r = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), chunks.chunk_ptr[1:].long()
                                - first)
    begin = offsets[r] + (torch.arange(chunks.count, device=dev) - first[r]) \
        * sparse_gather.SEGMENT_CHUNK
    crow = torch.cat([begin, begin.new_full((1,), entry.numel())]).to(torch.int32)
    csr = torch.sparse_csr_tensor(crow, cols[entry], vals[entry].float(), (chunks.count, width),
                                  check_invariants=False)
    return csr, entry


def _chunk_entry(torch, replaces: str, w, tail, chunks, case: str) -> dict:
    """The chunk kernel's entry of the kernels line
    (``sparse_gather.chunk_partials``) at one of its launch shapes: held
    against its plain version in f64 (every chunk within 1e-5·Σ|v·w| of its
    chunk, twice bitwise equal) and timed beside it. The bound counts the
    long rows' entries, the compact plan, the long rows' two pointers, the
    partials written and each distinct column of w (or row of r) those
    entries gather, once each, and 2 operations an entry. ``library_ms`` is
    cuSPARSE's product of a CSR matrix whose rows are the chunks with w
    (``_chunk_csr``), held to the same limit."""
    from photon_ml_torch.ops import sparse_gather

    vals, cols, _, row_ptr = tail
    p1 = sparse_gather.chunk_partials(w, tail, chunks)
    p2 = sparse_gather.chunk_partials(w, tail, chunks)
    wide = (vals.double(), *tail[1:])
    plain = sparse_gather.chunk_partials_reference(w.double(), wide, chunks)
    scale = sparse_gather.chunk_partials_reference(w.double().abs(), (wide[0].abs(), *tail[1:]),
                                                   chunks)
    csr, entry = _chunk_csr(torch, tail, chunks, w.shape[0])
    lib_share = float(((csr @ w).double() - plain).abs().div(1e-5 * scale + 1e-30).max())
    torch.cuda.synchronize()
    assert torch.equal(p1, p2), f"chunk kernel not bitwise repeatable: {case}"
    err = (p1.double() - plain).abs()
    share = float((err / (1e-5 * scale + 1e-30)).max())
    assert share <= 1.0, f"chunk kernel off its plain version ({share} of the limit): {case}"
    assert lib_share <= 1.0, f"the chunks' CSR product is another function: {case}"
    nnz = entry.numel()
    nbytes = nnz * (vals.element_size() + 4) + chunks.nbytes() + 8 * chunks.rows.numel() \
        + 4 * chunks.count + 4 * int(torch.unique(cols[entry]).numel())
    bound, by = _bound_ms(nbytes, 2.0 * nnz)
    del entry
    return {"name": "sparse_gather_chunks", "route": "cuda",
            "source": "photon_ml_torch/csrc/sparse_gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": float(err.max()),
            "ms": _device_ms(torch, lambda: sparse_gather.chunk_partials(w, tail, chunks)),
            "plain_ms": _device_ms(torch, lambda: sparse_gather.chunk_partials_reference(
                w, tail, chunks), reps=5, calls=2),
            "bound_ms": bound, "bound_by": by, "library_ms": _device_ms(torch, lambda: csr @ w),
            "library_note": "cuSPARSE CSR [chunks, d] @ w, the long rows' entries copied "
                            "contiguous outside the timing",
            "worst_err_share_of_limit": share, "case": case, "chunks": chunks.count,
            "long_rows": int(chunks.rows.numel()), "entries": nnz,
            "dtype": str(vals.dtype).replace("torch.", ""), "bytes": nbytes}


def _plan_bytes(plan) -> int:
    """Device bytes of a transpose plan (values, rows, pointers, chunk plan)."""
    vals, rows, col_ptr, chunks = plan
    return sum(t.numel() * t.element_size() for t in (vals, rows, col_ptr)) \
        + (0 if chunks is None else chunks.nbytes())


def _transpose_head_ms(torch, batch, r) -> float:
    """Device time of the hybrid head's share of the transpose: ``r'X_hot``
    and its ``index_add_`` into the distinct hot columns."""
    out = torch.zeros(batch.dim, device=r.device)
    return _device_ms(torch, lambda: out.index_add_(0, batch.hot_col_ids,
                                                    r @ batch.hot_vals.to(r.dtype)))


def _one_segment(torch, sparse_gather, dev, seed: int, nnz: int, d: int):
    """G1/G2's case: one row holding ``nnz`` random entries, with its chunk plan."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, d, (nnz,), dtype=torch.int32, device=dev, generator=gen)
    vals = torch.randn(nnz, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    row_ids = torch.zeros(nnz, dtype=torch.int32, device=dev)
    row_ptr, chunks = sparse_gather.segment_plan(row_ids, 1)
    return w, (vals, idx, row_ids, row_ptr), chunks


def _small_sparse_agreement(torch, np, seed: int, card) -> list[str]:
    """A small standardized logistic problem (16 random columns per row with
    values in [0.5, 1.5), plus an intercept column) trained on ``card`` in
    f32 and on the CPU in f64, ELL and column-sorted: the coefficients agree
    within 1e-3 max|w|. (Values near 0 in a column seen once give it a huge
    standardization factor, and f32 prefix sums of the column-sorted view
    then miss by more than that.) The card's ELL solve runs twice and must
    repeat bitwise: the gradient's transpose sums each column in a fixed
    order (``sparse_batch.tail_column_sums``). With float atomics
    (``index_add_``) some addition orders made the f32 L-BFGS stop at a
    failed line search a few iterations early (once 0.0175 from the f64
    optimum, 5.6x the limit), so the check passed or failed by that draw."""
    from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch, summarize_sparse
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.ops.normalization import NormalizationType, build_normalization
    from photon_ml_torch.types import TaskType

    n, d, per_row = (SPARSE["small"][k] for k in ("n", "d", "per_row"))
    rng = np.random.default_rng(seed + 7)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, d - 1, size=n * per_row)
    vals = rng.uniform(0.5, 1.5, size=n * per_row)
    z = np.bincount(rows, weights=vals * rng.normal(size=d)[cols] * 0.5, minlength=n) + 0.3
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.full(n, d - 1)])
    vals = np.concatenate([vals, np.ones(n)])
    stats = summarize_sparse(rows, cols, vals, n=n, dim=d)
    lines = []
    for layout in ("ell", "column_sorted"):
        got = {}
        for where, dtype in ((card, torch.float32), ("cpu", torch.float64), ("again", None)):
            if where == "again":  # the card's solve once more
                where, dtype = card, torch.float32
                got["first"] = got[card]
            batch = SparseLabeledPointBatch.from_coo(
                rows, cols, vals, y, dim=d, dtype=dtype, device=where,
                column_sorted_gradient=layout == "column_sorted")
            stat = {k: torch.as_tensor(stats[k], dtype=dtype, device=where)
                    for k in ("mean", "variance", "max_magnitude")}
            norm = build_normalization(NormalizationType.STANDARDIZATION, mean=stat["mean"],
                                       variance=stat["variance"],
                                       max_magnitude=stat["max_magnitude"],
                                       intercept_index=d - 1)
            models = train_glm(batch, TaskType.LOGISTIC_REGRESSION, regularization_weights=(1.0,),
                               normalization=norm, intercept_index=d - 1)
            got[where] = models[1.0].coefficients.means.double().cpu()
        gap = float((got[card] - got["cpu"]).abs().max())
        scale = float(got["cpu"].abs().max())
        repeat = bool(torch.equal(got["first"], got[card]))
        lines.append(f"small sparse problem n={n} d={d} {layout}: card f32 vs cpu f64 max |dw| "
                     f"{gap:.3g} (max |w| {scale:.3g}); two card solves bitwise equal: {repeat}")
        assert gap <= 1e-3 * scale, lines[-1]
        # the ELL scatters add in a fixed order; the column-sorted view's
        # prefix sums are reported, not required, to repeat
        assert repeat or layout != "ell", lines[-1]
    return lines


def final_solve(solves: list, run_name: str, lam: float) -> dict:
    """The record of ``run_name``'s solve at ``lam`` in a phase's solves."""
    return next(s for s in solves if s["run"] == run_name and s["lambda"] == lam)


def _sparse_slice(torch, np, seed: int, dev, card: str) -> list:
    """Phase 5: the sparse slice at full width, printing as it goes. Returns
    the sparse_gather entries of the kernels line."""
    from photon_ml_torch.data.sparse_batch import (
        HybridPolicy,
        SparseLabeledPointBatch,
        transpose_plan,
        sparse_column_sum,
        sparse_margins,
        summarize_sparse,
    )
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.ops import sparse_gather
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.ops.normalization import NormalizationType, build_normalization
    from photon_ml_torch.ops.sparse_objective import SparseGLMObjective
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    checks, entries, solves = [], [], []
    # launches of the row kernel (margins), the segment kernel (the
    # transposes) and the chunk kernel over the path's solves
    total = {"launches": 0, "segment_launches": 0, "chunk_launches": 0}

    def take():
        """The gather counters' launches since the last call (row, segment
        and chunk kernels), added to the path's totals; the counters go to 0."""
        got = {k: getattr(sparse_gather, k) for k in total}
        for k, v in got.items():
            total[k] += v
            setattr(sparse_gather, k, 0)
        return got

    def run(label, batch, use_kernel=None, **kw):
        """train_glm with the gather counters set to 0 before each λ's solve
        and read just after it; returns the models and the launches made
        after the last solve (the variances' Hessian diagonal)."""
        marks = {"t": time.perf_counter()}
        for k in total:
            setattr(sparse_gather, k, 0)

        def on_solve(lam, result):
            torch.cuda.synchronize()
            now = time.perf_counter()
            got = take()
            hist = result.value_history[: result.iterations + 1].double().cpu().numpy()
            solves.append({"run": label, "lambda": lam, "seconds": now - marks["t"],
                           "launches": got["launches"] + got["segment_launches"],
                           "margin_launches": got["launches"],
                           "transpose_launches": got["segment_launches"],
                           "iterations": result.iterations,
                           "reason": result.reason, "value": float(result.value),
                           "history": hist, "kernel": use_kernel is not False})
            marks["t"] = now

        models = train_glm(batch, TaskType.LOGISTIC_REGRESSION, use_kernel=use_kernel,
                           on_solve=on_solve, **kw)
        torch.cuda.synchronize()
        got = take()
        return models, got["launches"] + got["segment_launches"]

    def timed(step, label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        _log(f"{step} {label}: {time.perf_counter() - t0:.2f} s")
        return out

    # a. ELL at d=10^7 (bench_sparse_fe)
    n, d, per_row, n_held = (SPARSE["ell"][k] for k in ("n", "d", "per_row", "held_out"))
    (rows, cols, vals, y), held_coo = timed(
        "numpy data", f"ELL n={n} (+{n_held} held out) d={d}",
        lambda: _planted_ell_data(np, seed, n, d, per_row, n_held))
    ell = timed("from_coo", "ELL", lambda: SparseLabeledPointBatch.from_coo(
        rows, cols, vals, y, dim=d, device=dev))
    held = SparseLabeledPointBatch.from_coo(*held_coo, dim=d, device=dev)
    stats = timed("summarize_sparse", "ELL", lambda: summarize_sparse(rows, cols, vals, n=n, dim=d))
    del rows, cols, vals, held_coo
    stat = {k: torch.as_tensor(stats[k], dtype=torch.float32, device=dev)
            for k in ("mean", "variance", "max_magnitude")}
    scale = build_normalization(NormalizationType.SCALE_WITH_STANDARD_DEVIATION, **stat)
    del stats, stat
    _SHARED["ell"] = (ell, scale)  # phase 18's sparse grid runs on this batch
    ell16 = ell.replace(ell_vals=ell.ell_vals.to(torch.bfloat16),
                        values=ell.values.to(torch.bfloat16))
    width = ell.ell_vals.shape[1]
    assert ell.has_ell_view and ell.nnz == 0, "the ELL batch should have no flat tail"
    _log(f"ELL batch: [{n}, {width}] stored entries, flat tail {ell.nnz}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    w_chk = torch.randn(d, device=dev, generator=gen)
    checks.append(_gather_check(torch, "ELL f32", w_chk, n, ell=(ell.ell_vals, ell.ell_cols)))
    checks.append(_gather_check(torch, "ELL bf16", w_chk, n,
                                ell=(ell16.ell_vals, ell16.ell_cols)))

    lbfgs20 = OptimizerConfig(OptimizerType.LBFGS, max_iterations=20)
    common = dict(optimizer=lbfgs20, normalization=scale)
    models, _ = run("ell_lbfgs", ell, regularization_weights=(0.1, 1.0), **common)
    run("ell_owlqn", ell, regularization_weights=(1.0,), elastic_net_alpha=0.5, **common)
    run("ell_lbfgs_bf16", ell16, regularization_weights=(1.0,), **common)
    var_models, var_launches = run("ell_variance", ell, regularization_weights=(1.0,),
                                   compute_variance=True, **common)
    variances = var_models[1.0].coefficients.variances
    assert var_launches >= 1, "the Hessian diagonal launched no gather"
    assert variances.shape == (d,) and bool(torch.isfinite(variances).all()) \
        and bool((variances > 0).all()), "variances not finite and positive"
    _log(f"ELL variances (diagonal mode): min {float(variances.min()):.6g} max "
                 f"{float(variances.max()):.6g}, {var_launches} gather launch(es) after the solve")
    # Scaled by their deviations, the columns seen once or twice fit the
    # training rows alone: the loss heads for 0 and two f32 runs split (the
    # gradient scatter's atomics differ from run to run), so the scaled path
    # is repeated through the plain gather and through the kernel again and
    # the gaps are printed. bench.py's own setting (no normalization) is
    # well posed: it is held kernel against plain, and its λ=0.1 model to
    # the rows it did not see. Cut at 20 iterations its final values still
    # moved with rounding (up to 7e-5 rel apart on an H100), so these solves
    # may run on to a flat value.
    lbfgs100 = OptimizerConfig(OptimizerType.LBFGS, max_iterations=100)
    run("ell_lbfgs_plain", ell, use_kernel=False, regularization_weights=(0.1, 1.0), **common)
    run("ell_lbfgs_again", ell, regularization_weights=(0.1, 1.0), **common)
    plain_models, _ = run("ell_lbfgs_unscaled", ell, optimizer=lbfgs100,
                          regularization_weights=(0.1, 1.0))
    # phase 14 holds its column-sharded solves of this problem (from zero at
    # λ=1: L-BFGS with phase 5's 20-iteration budget, before f32 line searches
    # fail on the flat optimum, and TRON) against these one-device ones
    for label, opt in (("lbfgs", OptimizerConfig(OptimizerType.LBFGS,
                                                 **MODEL_AXIS["ell_lbfgs"])),
                       ("tron", OptimizerConfig(OptimizerType.TRON, **MODEL_AXIS["ell_tron"]))):
        one_device, _ = run(f"ell_{label}_lambda1", ell, optimizer=opt,
                            regularization_weights=(1.0,))
        _SHARED[f"ell_{label}"] = {
            "w": one_device[1.0].coefficients.means.float().cpu().numpy(),
            "solve": {k: final_solve(solves, f"ell_{label}_lambda1", 1.0)[k]
                      for k in ("iterations", "reason", "value", "seconds")}}
        del one_device
    run("ell_lbfgs_unscaled_plain", ell, use_kernel=False, optimizer=lbfgs100,
        regularization_weights=(0.1, 1.0))

    def final(run_name, lam):
        return final_solve(solves, run_name, lam)

    for lam in (0.1, 1.0):
        k, p, again = (final(r, lam) for r in ("ell_lbfgs", "ell_lbfgs_plain", "ell_lbfgs_again"))
        _log(f"scaled λ={lam:g}: final value kernel {k['value']:.8g} ({k['iterations']} "
             f"iterations), plain {p['value']:.8g} ({p['iterations']}), kernel again "
             f"{again['value']:.8g} ({again['iterations']}); rel gaps "
             f"{abs(k['value'] - p['value']) / abs(p['value']):.3g} to plain, "
             f"{abs(k['value'] - again['value']) / abs(k['value']):.3g} to the repeat")
        k, p = final("ell_lbfgs_unscaled", lam), final("ell_lbfgs_unscaled_plain", lam)
        gap = abs(k["value"] - p["value"]) / abs(p["value"])
        _log(f"unscaled λ={lam:g}: final value kernel {k['value']:.8g} ({k['iterations']} "
             f"iterations), plain {p['value']:.8g} ({p['iterations']}); rel gap {gap:.3g}")
        assert gap <= 1e-4, f"unscaled λ={lam}: kernel {k['value']} vs plain {p['value']}"

    def auc_of(model, batch, labels):
        margins = sparse_margins(batch, model.coefficients.means)
        return local_metrics.area_under_roc_curve(margins, labels)

    held_y = held.labels.cpu().numpy()
    for name, model in (("scaled λ=1", models[1.0]), ("scaled λ=0.1", models[0.1]),
                        ("unscaled λ=0.1", plain_models[0.1])):
        _log(f"ELL planted-signal model, {name}: training AUC {auc_of(model, ell, y):.6f}, "
             f"held-out AUC ({held.num_samples} rows) {auc_of(model, held, held_y):.6f}")
    auc = auc_of(plain_models[0.1], held, held_y)
    assert 0.6 < auc <= 1.0, f"held-out AUC {auc}"

    # one evaluation at the ELL shape and its parts (device times)
    obj = SparseGLMObjective(LogisticLoss(), l2_weight=1.0, normalization=scale)
    w_eval = 1e-2 * w_chk
    v1, g1 = obj.value_and_gradient(w_eval, ell)
    v2, g2 = obj.value_and_gradient(w_eval, ell)
    torch.cuda.synchronize()
    assert torch.equal(v1, v2), "the sparse value is not bitwise repeatable"
    assert torch.equal(g1, g2), \
        f"the sparse gradient is not bitwise repeatable: {float((g1 - g2).abs().max())}"
    r = torch.rand(n, device=dev, generator=gen)
    vg_ms = _device_ms(torch, lambda: obj.value_and_gradient(w_eval, ell))
    gather_ms = _device_ms(torch, lambda: sparse_gather.gather_sum(
        w_eval, n, ell=(ell.ell_vals, ell.ell_cols)))
    transpose_ms = _device_ms(torch, lambda: sparse_column_sum(ell, r))
    index_add_ms = _device_ms(torch, lambda: sparse_column_sum(ell, r, use_kernel=False))
    ell.__dict__.pop("_transpose_plan", None)  # time the plan's one-off build
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = transpose_plan(ell)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan_peak = torch.cuda.max_memory_allocated() - base
    plan_bytes = _plan_bytes(plan)
    _log(
        f"ELL evaluation n={n} d={d} L={width} f32 ({card}): value_and_gradient {vg_ms:.4f} ms "
        f"(eager {_eager_ms(torch, lambda: obj.value_and_gradient(w_eval, ell)):.4f} ms); "
        f"gather kernel {gather_ms:.4f} ms; gradient transpose (the gather kernel over the "
        f"column-sorted plan, a fixed order) {transpose_ms:.4f} ms; the plain index_add_ with "
        f"float atomics, for comparison, {index_add_ms:.4f} ms; the rest "
        f"{vg_ms - gather_ms - transpose_ms:.4f} ms; two gradients and values bitwise equal; "
        f"the plan's build (once per batch) {plan_s:.3f} s; the plan holds {plan_bytes} bytes "
        f"(values and rows {plan[0].numel() * 8}, column pointers {4 * (d + 1)}, the chunk plan "
        f"{0 if plan[3] is None else plan[3].nbytes()} for "
        f"{0 if plan[3] is None else plan[3].rows.numel()} long columns; a [d+1] chunk-pointer "
        f"array would add {4 * (d + 1)}), its build peaked {plan_peak} bytes above what "
        f"the phase held")
    g1_replaces = "experiments/sparse_gather_probe.py:70"
    entries.append(_gather_entry(torch, g1_replaces, w_eval, n, checks[0],
                                 ell=(ell.ell_vals, ell.ell_cols)))
    entries.append(_gather_entry(torch, g1_replaces, w_eval, n, checks[1],
                                 ell=(ell16.ell_vals, ell16.ell_cols)))
    for batch, dtype in ((ell, "f32"), (ell16, "bf16")):
        t_plan = transpose_plan(batch)
        t_tail = (t_plan[0], t_plan[1], None, t_plan[2])
        checks.append(_gather_check(
            torch, f"transpose of the ELL batch, {dtype} values (segments: its columns)", r, d,
            tail=t_tail, chunks=t_plan[3]))
        entries.append(_transpose_entry(torch, g1_replaces, r, d, checks[-1], t_plan,
                                        f"ELL [{n}, {width}]", plan_bytes=_plan_bytes(t_plan)))
        assert t_plan[3] is not None, "the planted columns should take the chunk kernel"
        entries.append(_chunk_entry(torch, g1_replaces, r, t_tail, t_plan[3],
                                    f"planted ELL transpose, {dtype} values"))
    del t_plan
    del ell, ell16, held, models, plain_models, var_models, variances, obj, g1, g2, plan
    torch.cuda.empty_cache()

    # b. hybrid at d=10^7 (bench_sparse_fe_hybrid)
    n, d, per_row, k_hot = (SPARSE["hybrid"][k] for k in ("n", "d", "per_row", "hot_cols"))
    rows, cols, vals, y = timed("numpy data", f"Zipf n={n} d={d}",
                                lambda: _zipf_data(np, seed + 11, n, d, per_row))
    hyb = timed("from_coo", f"hybrid hot_cols={k_hot}", lambda: SparseLabeledPointBatch.from_coo(
        rows, cols, vals, y, dim=d, hybrid=HybridPolicy(hot_cols=k_hot), device=dev))
    del rows, cols, vals
    assert hyb.has_hybrid_view and hyb.has_ell_view and hyb.nnz > 0
    _log(f"hybrid batch: head [{n}, {hyb.hot_vals.shape[1]}], hot coverage "
                 f"{hyb.layout['hot_coverage']:.6f} ({hyb.layout['hot_nnz']} of "
                 f"{hyb.layout['hot_nnz'] + hyb.layout['tail_nnz']} entries), ELL tail "
                 f"[{n}, {hyb.ell_vals.shape[1]}], flat tail {hyb.nnz}")
    tail = (hyb.values, hyb.col_indices, hyb.row_ids, hyb.row_ptr)
    checks.append(_gather_check(torch, "ELL+tail f32 (hybrid tail)", w_chk, n,
                                ell=(hyb.ell_vals, hyb.ell_cols), tail=tail,
                                chunks=hyb.row_chunks))
    run("hybrid_lbfgs", hyb, optimizer=OptimizerConfig(OptimizerType.LBFGS, max_iterations=10),
        regularization_weights=(0.1,))
    obj = SparseGLMObjective(LogisticLoss(), l2_weight=0.1)
    r = torch.rand(n, device=dev, generator=gen)
    vg_ms = _device_ms(torch, lambda: obj.value_and_gradient(w_eval, hyb))
    gather_ms = _device_ms(torch, lambda: sparse_gather.gather_sum(
        w_eval, n, ell=(hyb.ell_vals, hyb.ell_cols), tail=tail, chunks=hyb.row_chunks))
    head_ms = _device_ms(torch, lambda: hyb.hot_vals @ w_eval[hyb.hot_col_ids.long()])
    transpose_ms = _device_ms(torch, lambda: sparse_column_sum(hyb, r))
    t_plan = transpose_plan(hyb)
    checks.append(_gather_check(torch, "transpose of the hybrid tail, d=10^7", r, d,
                                tail=(t_plan[0], t_plan[1], None, t_plan[2]), chunks=t_plan[3]))
    t_head = _transpose_head_ms(torch, hyb, r)
    entries.append(_transpose_entry(torch, g1_replaces, r, d, checks[-1], t_plan,
                                    f"hybrid tail d={d}", head_ms=t_head,
                                    plan_bytes=_plan_bytes(t_plan)))
    # the plain transpose: index_add_ of every ELL slot (pad slots, value 0,
    # all in column 0) and of the flat tail
    plain_ms = _device_ms(torch, lambda: sparse_column_sum(hyb, r, use_kernel=False))
    _log(
        f"hybrid evaluation n={n} d={d} ({card}): value_and_gradient {vg_ms:.4f} ms; gather "
        f"kernel (ELL+tail) {gather_ms:.4f} ms; head product {head_ms:.4f} ms; gradient "
        f"transpose (head + the segment kernel over the column-sorted plan of the "
        f"{int(t_plan[0].numel())} nonzero tail entries) {transpose_ms:.4f} ms, of which the "
        f"segment kernel {entries[-1]['ms']:.4f} ms and the head's r'X_hot and index_add_ "
        f"{t_head:.4f} ms; "
        f"the rest {vg_ms - gather_ms - head_ms - transpose_ms:.4f} ms; the plain transpose "
        f"(index_add_ of the ELL tail's {hyb.ell_vals.numel()} slots and the flat tail, float "
        f"atomics), for comparison, {plain_ms:.4f} ms")
    del hyb, tail, obj, w_chk, w_eval, r, t_plan
    torch.cuda.empty_cache()

    # c. hybrid at d=10^8 with TRON (bench_sparse_fe_1e8)
    n, d, per_row, k_hot = (SPARSE["hybrid_1e8"][k] for k in ("n", "d", "per_row", "hot_cols"))
    rows, cols, vals, y = timed("numpy data", f"Zipf n={n} d={d}",
                                lambda: _zipf_data(np, seed + 5, n, d, per_row))
    big = timed("from_coo", f"hybrid hot_cols={k_hot}", lambda: SparseLabeledPointBatch.from_coo(
        rows, cols, vals, y, dim=d, hybrid=HybridPolicy(hot_cols=k_hot), device=dev))
    del rows, cols, vals
    _log(f"d=10^8 hybrid batch: head [{n}, {big.hot_vals.shape[1]}], hot coverage "
                 f"{big.layout['hot_coverage']:.6f}, ELL tail [{n}, {big.ell_vals.shape[1]}], "
                 f"flat tail {big.nnz}")
    w_big = torch.randn(d, device=dev, generator=gen)
    checks.append(_gather_check(torch, "ELL+tail f32 (hybrid tail, d=10^8)", w_big, n,
                                ell=(big.ell_vals, big.ell_cols),
                                tail=(big.values, big.col_indices, big.row_ids, big.row_ptr),
                                chunks=big.row_chunks))
    del w_big
    tron = OptimizerConfig(OptimizerType.TRON, max_iterations=3, max_cg_iterations=2)
    big_models, _ = run("hybrid_1e8_tron", big, optimizer=tron, regularization_weights=(0.1,))
    _SHARED["hybrid_1e8_tron"] = {
        "w": big_models[0.1].coefficients.means.float().cpu().numpy(),
        "solve": {k: final_solve(solves, "hybrid_1e8_tron", 0.1)[k]
                  for k in ("iterations", "reason", "value", "seconds")}}
    del big_models
    r = torch.rand(n, device=dev, generator=gen)
    t_plan = transpose_plan(big)
    checks.append(_gather_check(torch, "transpose of the hybrid tail, d=10^8", r, d,
                                tail=(t_plan[0], t_plan[1], None, t_plan[2]), chunks=t_plan[3]))
    t_head = _transpose_head_ms(torch, big, r)
    entries.append(_transpose_entry(torch, g1_replaces, r, d, checks[-1], t_plan,
                                    f"hybrid tail d={d}", head_ms=t_head,
                                    plan_bytes=_plan_bytes(t_plan)))
    _log(f"hybrid d={d} transpose ({card}): the segment kernel over {int(t_plan[0].numel())} "
         f"nonzero tail entries {entries[-1]['ms']:.4f} ms (cuSPARSE "
         f"{entries[-1]['library_ms']:.4f}, bound {entries[-1]['bound_ms']:.4f}); the head "
         f"{t_head:.4f} ms; whole transpose "
         f"{_device_ms(torch, lambda: sparse_column_sum(big, r)):.4f} ms")
    del big, t_plan, r
    torch.cuda.empty_cache()

    # the path's counts: every kernel solve launched the gather kernel
    for s in solves:
        h = s["history"]
        assert np.isfinite(h).all() and (np.diff(h) <= 0).all(), f"not decreasing: {s['run']}"
        if s["kernel"]:
            assert s["launches"] >= max(s["iterations"], 1), f"too few launches: {s['run']}"
        else:
            assert s["launches"] == 0, f"the plain run launched the kernel: {s['run']}"
    _log(f"sparse path: {len(solves)} solves, {total['launches']} sparse_gather row-kernel "
         f"launches (margins), {total['segment_launches']} segment-kernel launches (the "
         f"transposes), {total['chunk_launches']} chunk launches")
    assert total["launches"] > 0 and total["segment_launches"] > 0

    # d. ragged rows, G1 and G2
    n, d, width = (SPARSE["ragged"][k] for k in ("n", "d", "width"))
    rng = np.random.default_rng(seed + 17)
    counts = rng.integers(0, 40, size=n)
    counts[::7] = 0
    counts[[3, n // 2, n - 2]] = [5000, 20000, 3000]
    rows = np.repeat(np.arange(n), counts)
    ragged = SparseLabeledPointBatch.from_coo(
        rows, rng.integers(0, d, size=len(rows)), rng.normal(size=len(rows)).astype(np.float32),
        np.zeros(n, np.float32), dim=d, ell=width, device=dev)
    assert ragged.row_chunks is not None and ragged.nnz > 0
    w = torch.randn(d, device=dev, generator=gen)
    r_tail = (ragged.values, ragged.col_indices, ragged.row_ids, ragged.row_ptr)
    checks.append(_gather_check(
        torch, f"empty rows and rows of up to 20000 entries, ELL width {width}", w, n,
        ell=(ragged.ell_vals, ragged.ell_cols), tail=r_tail, chunks=ragged.row_chunks))
    entries.append(_chunk_entry(torch, g1_replaces, w, r_tail, ragged.row_chunks,
                                "ragged rows of up to 20000 entries"))
    del ragged, r_tail
    for key, replaces in (("g1", g1_replaces), ("g2", "experiments/sparse_gather_probe2.py:61")):
        nnz, d = SPARSE[key]["nnz"], SPARSE[key]["d"]
        w, tail, chunks = _one_segment(torch, sparse_gather, dev, seed + nnz, nnz, d)
        checks.append(_gather_check(torch, f"{key.upper()} one segment nnz={nnz} d={d}", w, 1,
                                    tail=tail, chunks=chunks, rel=1e-7))
        entries.append(_gather_entry(torch, replaces, w, 1, checks[-1], tail=tail,
                                     chunks=chunks))
        entries.append(_chunk_entry(torch, replaces, w, tail, chunks,
                                    f"{key.upper()} one segment nnz={nnz} d={d}"))
    _log(f"gather kernel checks: {json.dumps(checks)}")
    for text in _small_sparse_agreement(torch, np, seed, dev):
        _log(text)
    for entry in entries:
        if entry["name"] == "sparse_gather_chunks":
            entry["launches"] = total["chunk_launches"]
            _log(f"chunk kernel, {entry['case']} ({card}): {entry['ms']:.4f} ms over "
                 f"{entry['chunks']} chunks of {entry['long_rows']} long rows (bound "
                 f"{entry['bound_ms']:.4f}, plain {entry['plain_ms']:.4f}, cuSPARSE CSR "
                 f"{entry['library_ms']:.4f})")
            continue
        transpose = entry["layout"].startswith("transpose")
        entry["launches"] = total["segment_launches" if transpose else "launches"]
        entry["chunk_launches"] = total["chunk_launches"]
    for s in solves:
        rate = s["launches"] / s["seconds"]
        _log(f"sparse solve {s['run']} λ={s['lambda']:g}: {s['iterations']} iterations, "
                     f"reason {s['reason']}, {s['launches']} gather launches in "
                     f"{s['seconds']:.4f} s ({rate:.1f} launches/s), value {s['value']:.8g}")
    return entries


#: the GAME slice: bench.py's flagship GAME shape (bench_game_sweep), a larger
#: run whose times give a later benchmark a size to start from, and the small
#: problem held against the CPU
GAME = {
    "flagship": dict(n=1 << 17, d_fe=256, d_re=16, users=2000, items=1500, held_out=1 << 15,
                     sweeps=4),
    "large": dict(n=1 << 19, d_fe=256, d_re=16, users=8000, items=6000, held_out=0, sweeps=2),
    "small": dict(n=4096, d_fe=32, d_re=8, users=48, items=24, held_out=0, sweeps=3),
    "cap": 128,
}


def _game_arrays(np, seed: int, n: int, d_fe: int, d_re: int, users: int, items: int,
                 held_out: int, **_):
    """bench.py's GAME data (bench_game_sweep) with planted random effects:
    uniform user and item ids, standard-normal ``global`` and ``per_entity``
    shards in f32, bench.py's linear labels (a planted fixed effect plus unit
    noise) and logistic labels drawn from a planted fixed effect plus planted
    per-user and per-item effects. ``held_out`` more rows of the same model
    follow the training rows, a quarter of them of users never trained on."""
    rng = np.random.default_rng(seed)
    total = n + held_out
    user_idx = rng.integers(0, users, size=total)
    item_idx = rng.integers(0, items, size=total)
    if held_out:
        user_idx[n + 3 * held_out // 4:] += users
    x_fe = rng.standard_normal((total, d_fe), dtype=np.float32)
    x_re = rng.standard_normal((total, d_re), dtype=np.float32)
    w_fe = rng.normal(size=d_fe).astype(np.float32) / np.sqrt(d_fe)
    y_linear = x_fe @ w_fe + rng.normal(size=total).astype(np.float32)
    w_user = (0.5 * rng.normal(size=(2 * users, d_re))).astype(np.float32)
    w_item = (0.5 * rng.normal(size=(items, d_re))).astype(np.float32)
    z = x_fe @ w_fe + np.einsum("nd,nd->n", x_re, w_user[user_idx]) \
        + np.einsum("nd,nd->n", x_re, w_item[item_idx])
    y_logistic = (rng.uniform(size=total) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    keys = {"user": np.char.add("u", user_idx.astype(str)),
            "item": np.char.add("i", item_idx.astype(str))}

    def part(lo, hi):
        return dict(x_fe=x_fe[lo:hi], x_re=x_re[lo:hi],
                    keys={t: k[lo:hi] for t, k in keys.items()},
                    labels={"LINEAR_REGRESSION": y_linear[lo:hi],
                            "LOGISTIC_REGRESSION": y_logistic[lo:hi]})

    return part(0, n), (part(n, total) if held_out else None)


def _game_dataset(arrays, task: str, device, vocabs=None, dtype=None):
    from photon_ml_torch.data.game_data import build_game_dataset

    kw = {} if dtype is None else {"dtype": dtype}
    return build_game_dataset(
        labels=arrays["labels"][task],
        feature_shards={"global": arrays["x_fe"], "per_entity": arrays["x_re"]},
        entity_keys=arrays["keys"], entity_vocabs=vocabs, device=device, **kw)


def _game_estimator(task: str, lanes: str, sweeps: int, *, random_effects: bool = True, **kw):
    """bench.py's GAME configuration: L-BFGS (10 iterations) on the fixed
    effect, ``lanes`` (10 iterations) on the per-user and per-item effects,
    L2 weight 1 everywhere, one bucket of 128 slots per entity."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    def opt(kind):
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType[kind], max_iterations=10), l2_weight=1.0)

    configs = {"fixed": FixedEffectCoordinateConfig("global", opt("LBFGS"))}
    if random_effects:
        for cid, re_type in (("per_user", "user"), ("per_item", "item")):
            configs[cid] = RandomEffectCoordinateConfig(re_type, "per_entity", opt(lanes),
                                                        bucket_sizes=(GAME["cap"],))
    return GameEstimator(task=TaskType[task], coordinate_configs=configs, num_iterations=sweeps,
                         **kw)


class _GameTimers:
    """Wall-clock seconds (synchronized) of the coordinates' ``update_model``
    and ``score`` and of the bucket builder during one fit, by wrapping the
    port's methods; restored on exit."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds: dict = {}
        self._saved = []

    def _wrap(self, owner, name, key_of):
        fn = getattr(owner, name)
        torch, seconds = self.torch, self.seconds

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            key = key_of(*args, **kw)
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out

        self._saved.append((owner, name, fn))
        setattr(owner, name, timed)

    def __enter__(self):
        from photon_ml_torch import estimators
        from photon_ml_torch.algorithm import coordinates, mf_coordinate

        for cls in (coordinates.FixedEffectCoordinate, coordinates.RandomEffectCoordinate,
                    mf_coordinate.MatrixFactorizationCoordinate):
            self._wrap(cls, "update_model", lambda self_, *a, **k: f"solve {self_.coordinate_id}")
            self._wrap(cls, "score", lambda self_, *a, **k: "rescoring")
        for builder in ("build_random_effect_dataset", "build_mf_dataset"):
            self._wrap(estimators, builder, lambda *a, **k: "bucket builder")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)


def _game_fit(torch, label: str, estimator, dataset, sweeps: int) -> dict:
    """One ``GameEstimator.fit`` with the launch counters set to 0 just before
    and read just after. Every fixed-effect update must have launched the
    packed kernel once per evaluation and no other dense kernel."""
    from photon_ml_torch.algorithm.coordinates import lane_iteration_histogram
    from photon_ml_torch.ops import fused_glm, packed_glm
    from photon_ml_torch.optim.common import LaneTraces

    counters = ("packed_launches", "mma_launches", "columns_launches", "reduce_launches")
    for name in counters:
        setattr(packed_glm, name, 0)
    b1_before = fused_glm.launches
    updates, marks = [], {"packed": 0, "columns": 0}

    def on_update(iteration, cid, info):
        row = {"sweep": iteration, "coordinate": cid}
        if isinstance(info, LaneTraces):
            row["lane_iterations"] = lane_iteration_histogram(info)
        elif info is not None:
            packed, columns = packed_glm.packed_launches, packed_glm.columns_launches
            row.update(iterations=info.iterations, reason=info.reason,
                       evaluations=(packed - marks["packed"]) + (columns - marks["columns"]))
            marks.update(packed=packed, columns=columns)
        updates.append(row)

    estimator.on_update = on_update
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _GameTimers(torch) as timers:
        result = estimator.fit(dataset)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(packed_glm, name) for name in counters}
    uses_kernel = estimator.use_kernel is not False
    for row in updates:
        if "evaluations" in row:
            # every evaluation of the solve went through the packed kernel
            wanted = row["iterations"] + 1 if uses_kernel else 0
            assert (row["evaluations"] >= wanted) if uses_kernel else row["evaluations"] == 0, \
                f"{label}: fixed-effect update {row} launched too few packed kernels"
    assert fused_glm.launches == b1_before, f"{label}: the separate-column kernel was launched"
    assert launches["reduce_launches"] == launches["packed_launches"] + launches["columns_launches"]
    loss_name = next(k for k in result.metric_history[0] if k.startswith("train:"))
    last = [h[loss_name] for h in result.metric_history
            if h["coordinate"] == result.metric_history[-1]["coordinate"]]
    assert len(last) == sweeps and all(math.isfinite(v) for v in last), f"{label}: {last}"
    assert all(b <= a * (1 + 1e-5) for a, b in zip(last, last[1:])), \
        f"{label}: training loss rose over the sweeps: {last}"
    solves = {k: v for k, v in timers.seconds.items() if k.startswith("solve ")}
    known = sum(solves.values()) + timers.seconds.get("rescoring", 0.0) \
        + timers.seconds.get("bucket builder", 0.0)
    fe_rows = [r for r in updates if "evaluations" in r]
    lanes: dict = {}
    for r in updates:
        for its, count in r.get("lane_iterations", {}).items():
            lanes[its] = lanes.get(its, 0) + count
    out = {"fit": label, "seconds": seconds, "sweeps": sweeps,
           "seconds_per_sweep": (seconds - timers.seconds.get("bucket builder", 0.0)) / sweeps,
           "per_sweep": {k: v / sweeps for k, v in solves.items()},
           "rescoring_per_sweep": timers.seconds.get("rescoring", 0.0) / sweeps,
           "host_rest_per_sweep": (seconds - known) / sweeps,
           "bucket_builder_seconds": timers.seconds.get("bucket builder", 0.0),
           "fe_evaluations_per_solve": [r["evaluations"] for r in fe_rows],
           "fe_iterations_per_solve": [r["iterations"] for r in fe_rows],
           "lane_iteration_histogram": dict(sorted(lanes.items())),
           "loss_per_sweep": last, "launches": launches,
           "peak_memory_MiB": torch.cuda.max_memory_allocated() / 2**20}
    _log(f"GAME fit {json.dumps(out)}")
    out["result"] = result
    return out


def _rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _profiled(torch, fn) -> dict:
    """Wall ms of ``fn()`` (synchronized, after one warm-up call), beside the
    device ms and kernel count of a third call under ``torch.profiler``, and
    the lane loops' host reads of one call."""
    from photon_ml_torch.optim import common

    fn()
    torch.cuda.synchronize()
    reads = common.lane_host_reads
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = common.lane_host_reads - reads
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    total = sum(device_us(e) for e in events)
    return {"wall_ms": wall * 1e3, "device_ms": total / 1e3 if total else None,
            "kernels": sum(e.count for e in events if device_us(e) > 0), "host_reads": reads,
            "host_share": None if not total else max(0.0, 1.0 - total / 1e6 / wall)}


def _lane_loop_share(torch, estimator, dataset) -> dict:
    """Where one random-effect update's wall time goes: :func:`_profiled`
    over one ``update_model`` of the per-user coordinate from its initial
    model."""
    _, coordinates = estimator._build_coordinates(dataset, None)
    coord = coordinates["per_user"]
    model = coord.initial_model()
    return _profiled(torch, lambda: coord.update_model(model, None))


def _packed_entry(torch, name, replaces, launches, kernel, plain, library, x, n_aux_bytes,
                  limits, slack=None, **extra):
    """One ``packed_glm`` entry of the kernels line at the GAME fixed-effect
    shape: :func:`_path_check` on the main path's inputs, with the bound
    from the bytes (X, the aux columns, w in, the gradient, the value and
    Σr out) and 4 n d operations."""
    n, d = x.shape
    nbytes = n * d * x.element_size() + n_aux_bytes + 4 * d + 4 * d + 8
    check = _path_check(torch, name, kernel, plain, library, limits, nbytes, x.shape, slack)
    return {"name": name, "route": "cuda", "source": "photon_ml_torch/csrc/packed_glm.cu",
            "replaces": replaces, "launches": launches, **check,
            "eager_ms": _eager_ms(torch, kernel), "dtype": str(x.dtype).replace("torch.", ""),
            "bytes": nbytes, **extra}


#: the form of each of probes 1-3 that its kernels-line entry times: probe
#: 1's bf16 tensor-core form (mma_tf32 margins, bf16 mma gradient), its bf16
#: workaround with w and r in bf16 (P2) and its cast-up TF32 product (P3)
PROBE_ENTRY_VARIANT = {"P1": "P1 mxu/mxu t1024 bf16", "P2": "P2 mxu_w128/mxu_r128 t1024 bf16",
                       "P3": "P3 mxu_cast/mxu_cast t512 bf16"}


def _probe_entries(probe_rows) -> list:
    """The P1, P2 and P3 entries of the kernels line from the probe study's
    rows at [2^17, 512]: the entry variant's times, every variant's launches
    (its gradient steps) summed, the worst error over the probe's variants
    as a share of its limit, and each variant's times, bound and share. The
    bound counts X, y, ws and w read once and the gradient and value written
    once."""
    from dev import torch_kernel_probe

    library = {r["dtype"]: r["library_ms"] for r in probe_rows if "library_ms" in r}
    entries = []
    for probe, replaces in torch_kernel_probe.PROBE_REPLACES.items():
        rows = [r for r in probe_rows if r.get("kernel") == probe]
        main = next(r for r in rows if r["variant"] == PROBE_ENTRY_VARIANT[probe])
        n, d = main["shape"]

        def bound_of(r):
            itemsize = 2 if r["dtype"] == "bfloat16" else 4
            return _bound_ms(n * d * itemsize + 8 * n + 8 * d + 4, 4.0 * n * d)

        bound, by = bound_of(main)
        worst = max(rows, key=lambda r: r["limit_share"])
        entries.append({
            "name": f"packed_glm[{probe}]", "route": "cuda",
            "source": "photon_ml_torch/csrc/packed_glm.cu", "replaces": replaces,
            "launches": sum(r["launches"] for r in rows),
            "max_abs_err": max(r["grad_abs"] for r in rows),
            "worst_err_share_of_limit": worst["limit_share"], "worst_variant": worst["variant"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": library[main["dtype"]], "shape": [n, d], "dtype": main["dtype"],
            "form": f"{main['variant']}: columns, no o, no Σr, {main['margin_unit']}/"
                    f"{main['grad_unit']}, w rounded {main['round_w']}",
            "variants": [{"variant": r["variant"], "units": [r["margin_unit"], r["grad_unit"]],
                          "ms": r["ms"], "plain_ms": r["plain_ms"],
                          "bound_ms": bound_of(r)[0], "library_ms": library[r["dtype"]],
                          "err_share_of_limit": r["limit_share"]} for r in rows]})
    return entries


def _game_slice(torch, np, seed: int, dev, card: str) -> list:
    """The GAME slice at full width, printing as it goes. Returns the
    packed_glm entries of the kernels line."""
    from dev import torch_kernel_probe
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.optim import newton

    # a. the operand-form and unit study at the probes' shape (a phase of its own)
    for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
        setattr(packed_glm, name, 0)
    t0 = time.perf_counter()
    probe_rows = torch_kernel_probe.run(torch, _device_ms, seed, dev)
    for row in probe_rows:
        _log(f"kernel probe: {json.dumps(row)}")
    probe_launches = {name: getattr(packed_glm, name) for name in
                      ("packed_launches", "mma_launches", "columns_launches")}
    assert all(v > 0 for v in probe_launches.values()), probe_launches
    _log(f"kernel probe phase: {time.perf_counter() - t0:.2f} s, launches {probe_launches}")

    # b. the positive-definite solve of the Newton lanes at [2000, 16, 16]
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(2000, 32, 16, device=dev, generator=gen)
    h = torch.einsum("bnd,bne->bde", a, a) + torch.eye(16, device=dev)
    g = torch.randn(2000, 16, device=dev, generator=gen)
    p_chol, ok = newton.solve_pd(h, g)
    p_gj = newton.solve_pd_gauss_jordan(h, g)
    gap = float((p_chol - p_gj).abs().max() / p_gj.abs().max())
    assert bool(ok.all()) and gap <= 1e-4, f"Cholesky solve off Gauss-Jordan by {gap}"
    # eager times: the batched Cholesky solve allocates inside the library
    # call and cannot be captured in a CUDA graph
    _log(f"Newton solve [2000, 16, 16] f32 ({card}): cholesky_ex + cholesky_solve "
         f"{_eager_ms(torch, lambda: newton.solve_pd(h, g)):.4f} ms, Gauss-Jordan elimination "
         f"{_eager_ms(torch, lambda: newton.solve_pd_gauss_jordan(h, g)):.4f} ms (eager, one "
         f"call as the lane loop makes it), max rel gap {gap:.3g}")
    del a, h, g

    # c. the fits at the flagship shape
    shape = GAME["flagship"]
    sweeps = shape["sweeps"]
    t0 = time.perf_counter()
    train, held = _game_arrays(np, seed, **shape)
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = {task: _game_dataset(train, task, dev)
            for task in ("LOGISTIC_REGRESSION", "LINEAR_REGRESSION")}
    held_ds = _game_dataset(held, "LOGISTIC_REGRESSION", dev,
                            vocabs=data["LOGISTIC_REGRESSION"].entity_vocabs)
    torch.cuda.synchronize()
    _log(f"GAME data n={shape['n']} (+{shape['held_out']} held out) global d={shape['d_fe']} "
         f"per_entity d={shape['d_re']} users={shape['users']} items={shape['items']}: numpy "
         f"{t_arrays:.2f} s, build_game_dataset x3 {time.perf_counter() - t0:.2f} s")
    unseen = int((held_ds.entity_idx["user"] < 0).sum())
    assert unseen > 0, "the held-out rows should hold users never trained on"

    log, lin = "LOGISTIC_REGRESSION", "LINEAR_REGRESSION"
    fits = {}
    # warm up (kernel build caches, cuBLAS/cuSOLVER handles) outside the times
    _game_estimator(log, "NEWTON", 1).fit(data[log])
    _game_estimator(log, "LBFGS", 1, kernel_unit="mma").fit(data[log])
    for label, task, lanes, kw in (
            ("logistic lbfgs-lanes fma", log, "LBFGS", {}),
            ("logistic newton-lanes fma", log, "NEWTON", {}),
            ("logistic newton-lanes mma", log, "NEWTON", {"kernel_unit": "mma"}),
            ("logistic newton-lanes closed-form", log, "NEWTON", {"use_kernel": False}),
            ("linear lbfgs-lanes fma", lin, "LBFGS", {}),
            ("linear newton-lanes columns", lin, "NEWTON", {"kernel_aux": "columns"})):
        fits[label] = _game_fit(torch, label, _game_estimator(task, lanes, sweeps, **kw),
                                data[task], sweeps)
    fe_only = _game_fit(torch, "logistic fixed effect only", _game_estimator(
        log, "NEWTON", 1, random_effects=False), data[log], 1)

    def final(label):
        return fits[label]["loss_per_sweep"][-1]

    main = fits["logistic newton-lanes fma"]
    path_launches = {
        "P6": sum(f["launches"]["packed_launches"] - f["launches"]["mma_launches"]
                  for f in fits.values()),
        "P7": sum(f["launches"]["mma_launches"] for f in fits.values()),
        "P5": sum(f["launches"]["columns_launches"] for f in fits.values()),
        "reduce": sum(f["launches"]["reduce_launches"] for f in fits.values())}
    assert all(v > 0 for v in path_launches.values()), path_launches
    assert fits["logistic newton-lanes closed-form"]["launches"]["reduce_launches"] == 0
    gaps = {
        # the kernel and the closed form differ by f32 rounding only
        "kernel vs closed form": (_rel_gap(main["loss_per_sweep"][-1],
                                           final("logistic newton-lanes closed-form")), 1e-4),
        # TF32 operands perturb each evaluation by about 1e-6 relative; both
        # fits converge on the same optimum
        "fma vs mma": (_rel_gap(final("logistic newton-lanes mma"),
                                main["loss_per_sweep"][-1]), 1e-3),
        "lbfgs lanes vs newton lanes (logistic)": (_rel_gap(
            final("logistic lbfgs-lanes fma"), main["loss_per_sweep"][-1]), 1e-3),
        "lbfgs lanes vs newton lanes (linear)": (_rel_gap(
            final("linear lbfgs-lanes fma"), final("linear newton-lanes columns")), 1e-3)}
    _log("GAME final training loss, rel gaps (limit): " + ", ".join(
        f"{k} {v:.3g} ({lim:g})" for k, (v, lim) in gaps.items()))
    for k, (v, lim) in gaps.items():
        assert v <= lim, f"{k}: rel gap {v} > {lim}"

    held_y = held_ds.host_array("labels")
    aucs = {}
    for name, model in (("GAME", main["result"].model), ("fixed effect only",
                                                         fe_only["result"].model)):
        scores = model.score(held_ds)
        assert scores.shape == (shape["held_out"],) and bool(torch.isfinite(scores).all())
        aucs[name] = local_metrics.area_under_roc_curve(scores, held_y)
    train_scores = main["result"].model.score(data[log])
    assert train_scores.shape == (shape["n"],) and bool(torch.isfinite(train_scores).all())
    _log(f"GAME logistic AUC on {shape['held_out']} held-out rows ({unseen} of unseen users): "
         f"{aucs['GAME']:.6f} against the fixed effect alone {aucs['fixed effect only']:.6f}; "
         f"training AUC "
         f"{local_metrics.area_under_roc_curve(train_scores, data[log].host_array('labels')):.6f}")
    assert aucs["GAME"] > aucs["fixed effect only"] > 0.5, aucs

    share = _lane_loop_share(torch, _game_estimator(log, "LBFGS", 1), data[log])
    _log(f"lane loop, one per-user L-BFGS update [2000, 128, 16] ({card}): {json.dumps(share)}")
    share = _lane_loop_share(torch, _game_estimator(log, "NEWTON", 1), data[log])
    _log(f"lane loop, one per-user Newton update [2000, 128, 16] ({card}): {json.dumps(share)}")

    # d. the kernels at the shape and on the inputs the main path gives them
    ds = data[log]
    x = ds.feature_shards["global"]
    w = main["result"].model.get("fixed").glm.coefficients.means.float().contiguous()
    residual = main["result"].model.score(ds) - x @ w
    y, o, ws = ds.labels, (ds.offsets + residual).contiguous(), ds.weights
    aux = packed_glm.pack_aux(y, o, ws)
    loss = LogisticLoss()
    n = x.shape[0]
    r = torch.rand(n, device=dev)
    library = lambda: (torch.matmul(x, w), torch.matmul(r, x))  # noqa: E731
    # the TF32 variant (operands rounded to 10 mantissa bits against the
    # plain version's f32) is held to the f32 limits plus what TF32's
    # rounding can move each output by on these inputs
    tf32 = torch_kernel_probe.tf32_slack(loss, x, y, o, ws, w, None, "mma", "mma")
    p6 = "experiments/kernel_probe6.py:99"
    entries = [
        _packed_entry(torch, "packed_glm", p6, path_launches["P6"],
                      lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
                      lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
                      library, x, 12 * n, torch_kernel_probe.limits("float32"),
                      form="packed aux, fma, no Σr (the GAME path's call)"),
        _packed_entry(torch, "packed_glm[mma]", "experiments/kernel_probe7.py:112",
                      path_launches["P7"],
                      lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False,
                                                     margin_unit="mma", grad_unit="mma"),
                      lambda: packed_glm.packed_core_reference(
                          loss, x, aux, w, with_rsum=False, margin_unit="mma", grad_unit="mma"),
                      library, x, 12 * n, torch_kernel_probe.limits("float32"),
                      tf32, form="packed aux, mma (TF32) for both products"),
        _packed_entry(torch, "packed_glm[columns]", "experiments/kernel_probe5.py:121",
                      path_launches["P5"],
                      lambda: packed_glm.columns_core(loss, x, y, ws, o, w, with_rsum=False),
                      lambda: packed_glm.columns_core_reference(loss, x, y, ws, o, w,
                                                                with_rsum=False),
                      library, x, 12 * n, torch_kernel_probe.limits("float32"),
                      form="separate y, ws, o columns, no Σr"),
    ]
    p6_args = (loss, x, aux, None, None, None, w, None, True, "fma", "fma")
    entries.append({
        "name": "packed_glm_reduce", "route": "cuda",
        "source": "photon_ml_torch/csrc/glm_tile.cuh", "replaces": p6,
        "launches": path_launches["reduce"],
        **_reduce_entry(torch, "packed_glm_reduce", lambda: packed_glm.launch_partials(*p6_args),
                        packed_glm.reduce_partials, packed_glm.reduce_partials_reference)})
    keep = ("variant", "kernel", "dtype", "ms", "plain_ms", "frac")
    entries[0]["probe_shape_rows"] = [{k: r_[k] for k in keep if k in r_} for r_ in probe_rows
                                      if "ms" in r_]
    entries.extend(_probe_entries(probe_rows))
    # phase 18 fits the same logistic flagship again (its training rows)
    _SHARED["game_flagship"] = (train, data[log])
    del fits, fe_only, data, held_ds, train, held, x, aux, p6_args
    torch.cuda.empty_cache()

    # e. a small problem on the card (f32, the kernel) against the CPU (f64)
    small = GAME["small"]
    arrays, _ = _game_arrays(np, seed + 1, **small)
    got = {}
    for where, dtype in ((dev, None), ("cpu", np.float64)):
        ds = _game_dataset(arrays, log, where, dtype=dtype)
        model = _game_estimator(log, "NEWTON", small["sweeps"]).fit(ds).model
        got[str(where)] = torch.cat(
            [model.get("fixed").glm.coefficients.means.double().cpu()]
            + [model.get(c).coefficients.double().cpu().reshape(-1)
               for c in ("per_user", "per_item")])
    gap = float((got[str(dev)] - got["cpu"]).abs().max())
    scale = float(got["cpu"].abs().max())
    _log(f"small GAME problem n={small['n']}: card f32 vs cpu f64 max |dw| {gap:.3g} "
         f"(max |w| {scale:.3g})")
    assert gap <= 1e-3 * scale

    # f. the larger run: times for a later benchmark to start from
    shape = GAME["large"]
    t0 = time.perf_counter()
    train, _ = _game_arrays(np, seed + 2, **shape)
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = _game_dataset(train, log, dev)
    torch.cuda.synchronize()
    _log(f"large GAME data n={shape['n']} users={shape['users']} items={shape['items']}: numpy "
         f"{t_arrays:.2f} s, build_game_dataset {time.perf_counter() - t0:.2f} s")
    del train
    large = _game_fit(torch, "large logistic newton-lanes fma",
                      _game_estimator(log, "NEWTON", shape["sweeps"]), big, shape["sweeps"])
    assert large["launches"]["packed_launches"] > 0
    del big, large
    torch.cuda.empty_cache()
    return entries


#: the projected GAME slice: bench.py's flagship GAME shape with the per-user
#: effect on a wider shard, ``per_user_wide`` (d=512, column 0 an intercept,
#: each user owning 8-32 of columns 1-511)
PROJECTED = dict(n=1 << 17, d_fe=256, d_wide=512, d_re=16, users=2000, items=1500,
                 held_out=1 << 15, sweeps=4, owned=(8, 32), projected_dim=64, ratio=0.25,
                 l1=0.1)


def _projected_arrays(np, seed: int, n: int, d_fe: int, d_wide: int, d_re: int, users: int,
                      items: int, held_out: int, owned, **_):
    """:func:`_game_arrays`' layout plus ``per_user_wide``: each user owns
    ``owned`` columns of 1..d_wide-1 (drawn from ``seed``), its rows hold
    N(0, 1) values there, zeros elsewhere, 1 in column 0. Logistic labels
    from a planted fixed effect, a per-user model over each user's columns
    and a per-item effect on ``per_entity``; ``held_out`` more rows, a
    quarter of them of unseen users."""
    rng = np.random.default_rng(seed)
    total = n + held_out
    user_idx = rng.integers(0, users, size=total)
    item_idx = rng.integers(0, items, size=total)
    support = np.zeros((users, d_wide), dtype=bool)
    support[:, 0] = True
    for u in range(users):
        cols = rng.choice(d_wide - 1, size=int(rng.integers(owned[0], owned[1] + 1)),
                          replace=False)
        support[u, 1 + cols] = True
    x_wide = rng.standard_normal((total, d_wide), dtype=np.float32)
    x_wide *= support[user_idx]
    x_wide[:, 0] = 1.0
    x_fe = rng.standard_normal((total, d_fe), dtype=np.float32)
    x_re = rng.standard_normal((total, d_re), dtype=np.float32)
    w_fe = rng.normal(size=d_fe).astype(np.float32) / np.sqrt(d_fe)
    w_user = (0.5 * rng.normal(size=(users, d_wide)) * support).astype(np.float32)
    w_item = (0.5 * rng.normal(size=(items, d_re))).astype(np.float32)
    z = x_fe @ w_fe + np.einsum("nd,nd->n", x_wide, w_user[user_idx]) \
        + np.einsum("nd,nd->n", x_re, w_item[item_idx])
    y = (rng.uniform(size=total) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    keys = user_idx.copy()
    if held_out:
        keys[n + 3 * held_out // 4:] += users
    keys = {"user": np.char.add("u", keys.astype(str)),
            "item": np.char.add("i", item_idx.astype(str))}

    def part(lo, hi):
        return dict(shards={"global": x_fe[lo:hi], "per_user_wide": x_wide[lo:hi],
                            "per_entity": x_re[lo:hi]}, labels=y[lo:hi],
                    keys={t: k[lo:hi] for t, k in keys.items()})

    return part(0, n), part(n, total), support


def _projected_estimator(lanes: str, user_shard: str, sweeps: int, *, l1: float = 0.0,
                         max_iterations: int = 10, compute_variance: bool = False,
                         variance_mode: str = "auto", normalization: str = "NONE",
                         random_effects: bool = True, kernel_unit: str = "fma",
                         kernel_aux: str = "packed", **user):
    """bench.py's GAME configuration (``_game_estimator``) with the per-user
    effect on ``user_shard`` under ``user`` options (projector, width,
    Pearson ratio) and an L1 weight ``l1`` on both random effects."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.ops.normalization import NormalizationType
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    def opt(kind, **kw):
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType[kind], max_iterations=max_iterations
                                      if kind == lanes else 10), l2_weight=1.0, **kw)

    re_opt = dict(l1_weight=l1, compute_variance=compute_variance, variance_mode=variance_mode)
    configs = {"fixed": FixedEffectCoordinateConfig("global", opt("LBFGS"))}
    if random_effects:
        configs["per_user"] = RandomEffectCoordinateConfig(
            "user", user_shard, opt(lanes, **re_opt), bucket_sizes=(GAME["cap"],), **user)
        configs["per_item"] = RandomEffectCoordinateConfig(
            "item", "per_entity", opt(lanes, l1_weight=l1), bucket_sizes=(GAME["cap"],))
    return GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=configs,
                         num_iterations=sweeps, normalization=NormalizationType[normalization],
                         intercept_indices={"per_user_wide": 0}, kernel_unit=kernel_unit,
                         kernel_aux=kernel_aux)


def _bucket_bytes(torch, estimator, dataset) -> dict:
    """Bytes of the per-user coordinate's bucket tensors as this estimator
    builds them, with the bucket shapes and the build's seconds."""
    t0 = time.perf_counter()
    _, coordinates = estimator._build_coordinates(dataset, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    re = coordinates["per_user"].re_dataset
    fields = ("features", "labels", "weights", "entity_rows", "sample_rows", "col_index")
    total = sum(getattr(b, f).numel() * getattr(b, f).element_size() for b in re.buckets
                for f in fields if getattr(b, f) is not None)
    return {"projector": re.projector_type.value, "bytes": total,
            "shapes": [list(b.features.shape) for b in re.buckets], "build_seconds": seconds}


def _per_user_update(torch, estimator, dataset, model):
    """One update of ``estimator``'s per-user coordinate from ``model``'s
    per-user table with the residuals of ``model``'s other coordinates:
    (the training loss of the model it gives, the new table)."""
    from photon_ml_torch.evaluation.evaluators import EvaluationData, default_evaluator_for_task

    _, coordinates = estimator._build_coordinates(dataset, None)
    coord = coordinates["per_user"]
    others = model.get("fixed").score_dataset(dataset) + model.get("per_item").score_dataset(
        dataset)
    new, _ = coord.update_model(model.get("per_user"), others)
    total = (others + coord.score(new)).cpu().numpy() + dataset.host_array("offsets")
    data = EvaluationData(labels=dataset.host_array("labels"),
                          offsets=dataset.host_array("offsets"),
                          weights=dataset.host_array("weights"), ids=dataset.ids)
    return default_evaluator_for_task(estimator.task).evaluate(total, data), new.coefficients


def _projected_slice(torch, np, seed: int, dev, card: str) -> dict:
    """The projected GAME slice at the flagship shape: INDEX_MAP, RANDOM,
    Pearson selection, normalization and variances on the per-user effect,
    and OWL-QN and TRON lanes, each through ``GameEstimator.fit`` with the
    fixed effect on the packed kernel. Returns, for each kernel this path
    runs, its launches here and its check on the path's own fixed-effect
    inputs."""
    from dev import torch_kernel_probe
    from photon_ml_torch.data.game_data import build_game_dataset
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss

    shape = PROJECTED
    sweeps = shape["sweeps"]
    t0 = time.perf_counter()
    train, held, support = _projected_arrays(np, seed + 5, **shape)
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = build_game_dataset(labels=train["labels"], feature_shards=train["shards"],
                            entity_keys=train["keys"], device=dev)
    held_ds = build_game_dataset(labels=held["labels"], feature_shards=held["shards"],
                                 entity_keys=held["keys"], entity_vocabs=ds.entity_vocabs,
                                 device=dev)
    torch.cuda.synchronize()
    owned = support.sum(axis=1) - 1
    _log(f"projected GAME data n={shape['n']} (+{shape['held_out']} held out) global "
         f"d={shape['d_fe']} per_user_wide d={shape['d_wide']} (each user owns {owned.min()}-"
         f"{owned.max()} columns, mean {owned.mean():.1f}, plus the intercept) per_entity "
         f"d={shape['d_re']} users={shape['users']} items={shape['items']}: numpy "
         f"{t_arrays:.2f} s, build_game_dataset x2 {time.perf_counter() - t0:.2f} s")
    del train, held

    # bucket bytes of the per-user coordinate under each projector
    buckets = {name: _bucket_bytes(torch, _projected_estimator("NEWTON", "per_user_wide", 1,
                                                               **kw), ds)
               for name, kw in (("IDENTITY", {}), ("INDEX_MAP", {"projector_type": "INDEX_MAP"}),
                                ("RANDOM", {"projector_type": "RANDOM",
                                            "projected_dim": shape["projected_dim"]}))}
    _log(f"per-user bucket bytes [{shape['users']} users, {GAME['cap']} slots] ({card}): "
         + json.dumps(buckets))
    torch.cuda.empty_cache()

    wide, im = "per_user_wide", {"projector_type": "INDEX_MAP"}
    rnd = {"projector_type": "RANDOM", "projected_dim": shape["projected_dim"]}
    # warm up outside the times (cuSOLVER and cuBLAS handles, the kernels)
    _projected_estimator("NEWTON", wide, 1, **im).fit(ds)
    _projected_estimator("TRON", "per_entity", 1).fit(ds)
    plan = {
        "a. index-map newton": ("NEWTON", wide, im),
        "a. identity d=512 newton": ("NEWTON", wide, {}),
        "b. index-map standardized, full variances": (
            "NEWTON", wide, dict(im, normalization="STANDARDIZATION", compute_variance=True,
                                 variance_mode="full")),
        "c. random k=64 scaled lbfgs, full variances": (
            "LBFGS", wide, dict(rnd, normalization="SCALE_WITH_STANDARD_DEVIATION",
                                compute_variance=True, variance_mode="full")),
        "c. random k=64 scaled lbfgs, diagonal variances": (
            "LBFGS", wide, dict(rnd, normalization="SCALE_WITH_STANDARD_DEVIATION",
                                compute_variance=True, variance_mode="diagonal")),
        "d. index-map pearson 0.25, mma": (
            "NEWTON", wide, dict(im, features_to_samples_ratio=shape["ratio"],
                                 kernel_unit="mma")),
        "e. per_entity newton": ("NEWTON", "per_entity", {}),
        "e. per_entity tron, columns": ("TRON", "per_entity", {"kernel_aux": "columns"}),
        "e. per_entity elastic-net owlqn": ("OWLQN", "per_entity", {"l1": shape["l1"]}),
    }
    fits = {}
    for label, (lanes, shard, kw) in plan.items():
        fits[label] = _game_fit(torch, label, _projected_estimator(lanes, shard, sweeps, **kw),
                                ds, sweeps)
        torch.cuda.empty_cache()
    fe_only = _game_fit(torch, "projected: fixed effect only", _projected_estimator(
        "NEWTON", wide, 1, random_effects=False), ds, 1)

    def final(label):
        return fits[label]["loss_per_sweep"][-1]

    def user_table(label):
        return fits[label]["result"].model.get("per_user")

    # a. INDEX_MAP against IDENTITY over the same 512 columns: the whole
    # fits, and one per-user update of each from the same model and residuals
    gap = _rel_gap(final("a. index-map newton"), final("a. identity d=512 newton"))
    t_im = user_table("a. index-map newton").coefficients.double().cpu().numpy()
    t_id = user_table("a. identity d=512 newton").coefficients.double().cpu().numpy()
    rows = np.array([int(k[1:]) for k in user_table("a. identity d=512 newton").entity_keys])
    on = support[rows]
    coef_gap = float(np.abs(t_im - t_id)[on].max())
    scale = float(np.abs(t_id).max())
    off_zero = bool((t_id[~on] == 0.0).all() and (t_im[~on] == 0.0).all())
    start = fits["a. identity d=512 newton"]["result"].model
    one = {name: _per_user_update(torch, _projected_estimator("NEWTON", wide, 1, **kw), ds, start)
           for name, kw in (("INDEX_MAP", im), ("IDENTITY", {}))}
    one_gap = _rel_gap(one["INDEX_MAP"][0], one["IDENTITY"][0])
    one_w = {k: v[1].double().cpu().numpy() for k, v in one.items()}
    one_coef_gap = float(np.abs(one_w["INDEX_MAP"] - one_w["IDENTITY"])[on].max())
    one_off_zero = bool((one_w["IDENTITY"][~on] == 0.0).all()
                        and (one_w["INDEX_MAP"][~on] == 0.0).all())
    _log(f"a. INDEX_MAP vs IDENTITY d={shape['d_wide']} ({card}): one per-user update from the "
         f"same model and residuals: training loss rel gap {one_gap:.3g} (limit 1e-5), "
         f"on-support coefficients max |dw| {one_coef_gap:.3g}; the {sweeps}-sweep fits: final "
         f"training loss rel gap {gap:.3g} (limit 1e-4: the fixed effect's L-BFGS stops at its "
         f"function tolerance, 1e-7, one iteration apart on f32-different residuals; "
         f"iterations {fits['a. index-map newton']['fe_iterations_per_solve']} and "
         f"{fits['a. identity d=512 newton']['fe_iterations_per_solve']}), on-support "
         f"coefficients max |dw| {coef_gap:.3g} (limit 1e-3 · max|w| = {1e-3 * scale:.3g}), "
         f"off-support coefficients exactly 0: {off_zero and one_off_zero}")
    assert one_gap <= 1e-5 and one_coef_gap <= 1e-3 * scale and one_off_zero
    assert gap <= 1e-4 and coef_gap <= 1e-3 * scale and off_zero

    # b. variances finite and positive on each support, NaN off it
    var_b = user_table("b. index-map standardized, full variances").variances
    var_b = var_b.double().cpu().numpy()
    assert np.isfinite(var_b[on]).all() and (var_b[on] > 0).all() and np.isnan(var_b[~on]).all()
    # c. RANDOM variances finite and positive, full and diagonal
    var_c = {mode: user_table(f"c. random k=64 scaled lbfgs, {mode} variances").variances
             .double().cpu().numpy() for mode in ("full", "diagonal")}
    for mode, v in var_c.items():
        assert np.isfinite(v).all() and (v > 0).all(), mode
    _log(f"b./c. variances ({card}): INDEX_MAP full on support {var_b[on].min():.4g}-"
         f"{var_b[on].max():.4g}, NaN off it; RANDOM full {var_c['full'].min():.4g}-"
         f"{var_c['full'].max():.4g}, diagonal {var_c['diagonal'].min():.4g}-"
         f"{var_c['diagonal'].max():.4g}")
    # e. TRON against Newton lanes
    gap_e = _rel_gap(final("e. per_entity tron, columns"), final("e. per_entity newton"))
    _log(f"e. TRON vs Newton lanes final training loss rel gap {gap_e:.3g} (limit 1e-3)")
    assert gap_e <= 1e-3

    held_y = held_ds.host_array("labels")
    aucs = {label: local_metrics.area_under_roc_curve(
        f["result"].model.score(held_ds), held_y) for label, f in fits.items()}
    fe_auc = local_metrics.area_under_roc_curve(fe_only["result"].model.score(held_ds), held_y)
    _log(f"projected GAME held-out AUC on {shape['held_out']} rows ({card}): "
         + json.dumps(aucs) + f"; fixed effect alone {fe_auc:.6f}")
    assert all(a > fe_auc > 0.5 for a in aucs.values()), (aucs, fe_auc)
    for label, f in fits.items():
        _log(f"projected fit {label} ({card}): seconds per sweep {f['seconds_per_sweep']:.4f}, "
             f"by coordinate {json.dumps(f['per_sweep'])}, rescoring "
             f"{f['rescoring_per_sweep']:.4f}, host rest {f['host_rest_per_sweep']:.4f}; lane "
             f"iterations {json.dumps(f['lane_iteration_histogram'])}")

    # the lanes' wall and device time per update, with kernels and host reads
    for label, (lanes, shard, kw) in plan.items():
        if "identity" in label or "diagonal" in label:
            continue
        est = _projected_estimator(lanes, shard, 1, **{k: v for k, v in kw.items()
                                                       if k not in ("kernel_unit",
                                                                    "kernel_aux")})
        share = _lane_loop_share(torch, est, ds)
        _log(f"lane loop, one per-user update, {label} ({card}): {json.dumps(share)}")

    # the kernels on this path's own fixed-effect inputs (fit a's model)
    model = fits["a. index-map newton"]["result"].model
    x = ds.feature_shards["global"]
    w = model.get("fixed").glm.coefficients.means.float().contiguous()
    o = (ds.offsets + model.score(ds) - x @ w).contiguous()
    aux = packed_glm.pack_aux(ds.labels, o, ds.weights)
    loss = LogisticLoss()
    n = x.shape[0]
    r = torch.rand(n, device=dev)
    library = lambda: (torch.matmul(x, w), torch.matmul(r, x))  # noqa: E731
    nbytes = n * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8
    limits = torch_kernel_probe.limits("float32")
    tf32 = torch_kernel_probe.tf32_slack(loss, x, ds.labels, o, ds.weights, w, None, "mma",
                                         "mma")
    launches = {k: sum(f["launches"][k] for f in fits.values())
                for k in ("packed_launches", "mma_launches", "columns_launches",
                          "reduce_launches")}
    path = {
        "packed_glm": dict(_path_check(
            torch, "packed_glm on the projected slice's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
            library, limits, nbytes, x.shape),
            launches=launches["packed_launches"] - launches["mma_launches"]),
        "packed_glm[mma]": dict(_path_check(
            torch, "packed_glm[mma] on the projected slice's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False, margin_unit="mma",
                                           grad_unit="mma"),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False,
                                                     margin_unit="mma", grad_unit="mma"),
            library, limits, nbytes, x.shape, tf32), launches=launches["mma_launches"]),
        "packed_glm[columns]": dict(_path_check(
            torch, "packed_glm[columns] on the projected slice's fixed effect",
            lambda: packed_glm.columns_core(loss, x, ds.labels, ds.weights, o, w,
                                            with_rsum=False),
            lambda: packed_glm.columns_core_reference(loss, x, ds.labels, ds.weights, o, w,
                                                      with_rsum=False),
            library, limits, nbytes, x.shape), launches=launches["columns_launches"]),
    }
    fe_args = (loss, x, aux, None, None, None, w, None, False, "fma", "fma")
    path["packed_glm_reduce"] = dict(
        _reduce_entry(torch, "packed_glm_reduce on the projected slice's fixed effect",
                      lambda: packed_glm.launch_partials(*fe_args), packed_glm.reduce_partials,
                      packed_glm.reduce_partials_reference),
        launches=launches["reduce_launches"])
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    _log(f"kernels on the projected slice's fixed effect {list(x.shape)} ({card}): "
         + json.dumps(path))
    del fits, fe_only, ds, held_ds, x, aux, model, fe_args
    torch.cuda.empty_cache()
    return path


#: phase 8's rows: the flagship GAME widths (bench.py:542-560) with the rows
#: cut to 8,192 training and 2,048 validation rows, users and items cut to
#: keep about the flagship's 66 and 87 rows per entity; the dense GLM width
#: (bench.py:59, 511 features plus the intercept) with 4,096 training and
#: 1,024 validation rows. The pure-Python Avro codec is the cost that cuts them.
DRIVERS = dict(game_rows=8192, validation_rows=2048, users=125, items=95, d_fe=255, d_re=16,
               glm_rows=4096, glm_validation_rows=1024, glm_d=512)


def _game_avro_schema():
    """TrainingExampleAvro with a second feature bag, ``perEntityFeatures``,
    for the per-user and per-item effects."""
    from photon_ml_torch.io import photon_schemas as schemas

    feature = f"{schemas.NAMESPACE}.FeatureAvro"
    return dict(schemas.TRAINING_EXAMPLE_AVRO, name="GameTrainingExampleAvro", fields=[
        *schemas.TRAINING_EXAMPLE_AVRO["fields"],
        {"name": "perEntityFeatures", "type": {"type": "array", "items": feature}}])


def _write_avro(path, schema, rows: int, make) -> float:
    """Write ``make(i)`` for i < rows into one container file; seconds."""
    from photon_ml_torch.io import avro

    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    avro.write_container(path, schema, (make(i) for i in range(rows)))
    return time.perf_counter() - t0


def _ntv(prefix, values):
    return [{"name": f"{prefix}{j}", "term": "", "value": v} for j, v in enumerate(values)]


def _write_game_part(args) -> float:
    """Write one GAME part file of ``_game_arrays`` rows (logistic labels,
    ``global`` and ``perEntityFeatures`` bags, user and item ids in the
    metadata map) with the port's pure-Python writer; seconds. A module
    function, so a process pool can run it."""
    path, x_fe, x_re, y, users, items, offset = args
    x_fe, x_re, y = x_fe.tolist(), x_re.tolist(), y.tolist()
    users, items = users.tolist(), items.tolist()
    return _write_avro(path, _game_avro_schema(), len(y), lambda i: {
        "uid": str(offset + i), "label": y[i], "features": _ntv("g", x_fe[i]),
        "perEntityFeatures": _ntv("e", x_re[i]), "weight": 1.0, "offset": 0.0, "foldId": None,
        "metadataMap": {"userId": users[i], "itemId": items[i]}})


def _write_glm_part(args) -> float:
    """Write one GLM part file (``x`` without the intercept column, labels,
    uids from ``offset``) with the port's pure-Python writer; seconds. A
    module function, so a process pool can run it."""
    from photon_ml_torch.io import photon_schemas

    path, x, y, offset = args
    x, y = x.tolist(), y.tolist()
    return _write_avro(path, photon_schemas.TRAINING_EXAMPLE_AVRO, len(y), lambda i: {
        "uid": str(offset + i), "label": y[i], "features": _ntv("f", x[i]), "weight": 1.0,
        "offset": 0.0, "foldId": None, "metadataMap": None})


def _game_parts(part, directory, offset: int, parts: int, cluster: bool = False) -> list:
    """The pool arguments writing ``part``'s rows as ``parts`` part files
    of ``directory`` (row order kept across the sorted part names; with
    ``cluster`` the rows sorted by user first and each file ending where a
    user's rows end, so every user's rows are in one file)."""
    import numpy as np

    n = len(part["labels"]["LOGISTIC_REGRESSION"])
    order = np.argsort(part["keys"]["user"], kind="stable") if cluster else slice(None)
    x_fe, x_re = part["x_fe"][order], part["x_re"][order]
    y = part["labels"]["LOGISTIC_REGRESSION"][order]
    users, items = part["keys"]["user"][order], part["keys"]["item"][order]
    bounds = [n * i // parts for i in range(parts + 1)]
    if cluster:
        starts = np.append(np.flatnonzero(np.r_[True, users[1:] != users[:-1]]), n)
        bounds = [int(starts[np.searchsorted(starts, b)]) for b in bounds]
    return [(os.path.join(directory, f"part-{i:05d}.avro"), x_fe[lo:hi], x_re[lo:hi],
             y[lo:hi], users[lo:hi], items[lo:hi], offset + lo)
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]


#: a directory that phases share files through, kept to the end of the run
_SHARED: dict = {}

#: the flagship's rows as Avro, at two depths: "uncut" for phase 8's driver
#: run at the flagship's rows (2^17 training, 2^15 validation); "cut" (a
#: quarter of those rows, the widths, users and items kept) for the later
#: phases' drivers and readers (12(d), 13, 14(e), 17(e), 18(b)), whose
#: native decode is a pass over the whole file each read
FLAGSHIP_AVRO = {"uncut": dict(n=1 << 17, held_out=1 << 15),
                 "cut": dict(n=1 << 15, held_out=1 << 13)}


def _flagship_jobs(np, seed: int, size: str, base: Path) -> tuple:
    """The pool arguments writing the flagship's rows at ``size`` under
    ``base`` (``_write_game_part``'s), and what ``_flagship_avro`` returns
    of them."""
    shape = dict(GAME["flagship"], d_fe=GAME["flagship"]["d_fe"] - 1, **FLAGSHIP_AVRO[size])
    n, nv = shape["n"], shape["held_out"]
    train, held = _game_arrays(np, seed + 12, **shape)
    jobs = _game_parts(train, base / "train", 0, 16, cluster=True) \
        + _game_parts(held, base / "validation", n, 8)
    return jobs, {"seed": seed, "size": size, "train": base / "train",
                  "validation": base / "validation", "n": n, "held_out": nv,
                  "d_fe": shape["d_fe"]}


def _driver_avro_jobs(np, seed: int, base: Path) -> tuple:
    """Phase 8's Avro under ``base``: the GAME rows (training in two part
    files, one a day for the date-range run; validation in one) and the GLM
    rows, as (``_write_game_part`` jobs, ``_write_glm_part`` jobs)."""
    cfg = DRIVERS
    n, nv = cfg["game_rows"], cfg["validation_rows"]
    train, held = _game_arrays(np, seed + 3, n=n, d_fe=cfg["d_fe"], d_re=cfg["d_re"],
                               users=cfg["users"], items=cfg["items"], held_out=nv)
    ng, ngv, dg = cfg["glm_rows"], cfg["glm_validation_rows"], cfg["glm_d"]
    x, y = _dataset(np, seed + 4, ng + ngv, dg)
    x = x[:, :-1]  # the last column is the driver's intercept
    jobs = _game_parts(train, base / "game/train", 0, 2) \
        + _game_parts(held, base / "game/validation", n, 1)
    glm_jobs = [(str(base / "glm/train/part-00000.avro"), x[:ng], y[:ng], 0),
                (str(base / "glm/validation/part-00000.avro"), x[ng:], y[ng:], ng)]
    return jobs, glm_jobs


def _start_prewrites(np, seed: int) -> None:
    """Start writing, in a pool of processes (the port's pure-Python Avro
    writer, a part file a task) while phases 3-7b run on the card, the Avro
    that later phases read: phase 8's GAME and GLM rows, the flagship's
    rows uncut and cut, and phase 13's sparse rows, in the order they are
    read, all under ``_SHARED["dir"]``. A phase takes its files with
    ``_prewritten``; one run without this (a phase alone) writes them itself."""
    base = Path(_SHARED["dir"]) / "prewritten"
    workers = max(1, min(4, (os.cpu_count() or 1) - 2))
    # below the phases' own processes in the host's scheduler
    pool = _processes().Pool(workers, initializer=os.nice, initargs=(10,))
    atexit.register(pool.terminate)
    groups = {}

    def submit(key, fn, jobs, info):
        groups[key] = {"result": pool.map_async(fn, jobs), "info": info}

    game_jobs, glm_jobs = _driver_avro_jobs(np, seed, base / "drivers")
    submit("drivers-game", _write_game_part, game_jobs, {"dir": base / "drivers"})
    submit("drivers-glm", _write_glm_part, glm_jobs, {"dir": base / "drivers"})
    for size in ("uncut", "cut"):
        jobs, info = _flagship_jobs(np, seed, size, base / f"flagship-{size}")
        submit(f"flagship-{size}", _write_game_part, jobs, info)
    jobs, info = _sparse_avro_jobs(np, seed, base / "sparse")
    submit("sparse", _write_sparse_part, jobs, info)
    _SHARED["prewrites"] = {"pool": pool, "groups": groups, "workers": workers}


def _prewritten(key: str) -> dict | None:
    """The files of ``_start_prewrites``' group ``key`` once written: its
    info plus "part_seconds" (each part's writer seconds) and "workers";
    None when nothing was started. The pool closes once every group was
    taken."""
    pre = _SHARED.get("prewrites")
    if pre is None or key not in pre["groups"]:
        return None
    group = pre["groups"][key]
    if "part_seconds" not in group:
        group["part_seconds"] = group["result"].get()
    if not pre.get("closed") and all("part_seconds" in g for g in pre["groups"].values()):
        pre["pool"].close()
        pre["pool"].join()
        pre["closed"] = True
    return dict(group["info"], part_seconds=group["part_seconds"], workers=pre["workers"])


def _flagship_avro(np, seed: int, fallback: Path, size: str = "cut") -> dict:
    """The flagship's rows at ``size`` (``FLAGSHIP_AVRO``) as Avro, written
    once a run at each size (by ``_start_prewrites``, else here by a pool):
    the training rows at the flagship widths (255 global features, the
    drivers add the intercept; 16 per-entity; 2000 users, 1500 items) as 16
    part files clustered by user, so that a partitioned read keeps each user
    on one rank while items span the ranks, and the validation rows as 8
    part files, a quarter of them of unseen users. In ``_SHARED["dir"]``,
    else in ``fallback``. Returns {"train", "validation", "n", "held_out",
    "write_seconds" (wall seconds, or the parts' writer seconds summed when
    written in the background), "workers", "background"}."""
    cached = _SHARED.get(f"flagship-{size}")
    if cached is not None and cached["seed"] == seed and Path(cached["train"]).is_dir():
        return cached
    pre = _prewritten(f"flagship-{size}")
    if pre is not None and pre["seed"] == seed:
        out = dict(pre, write_seconds=sum(pre["part_seconds"]), background=True)
    else:
        jobs, info = _flagship_jobs(np, seed, size, Path(_SHARED.get("dir", fallback))
                                    / f"flagship-{size}")
        workers = min(8, os.cpu_count() or 1)
        t0 = time.perf_counter()
        with _processes().Pool(workers) as pool:
            pool.map(_write_game_part, jobs)
        out = dict(info, write_seconds=time.perf_counter() - t0, workers=workers,
                   background=False)
    if "dir" in _SHARED:
        _SHARED[f"flagship-{size}"] = out
    return out


def _same_read(torch, np, a, b) -> None:
    """Two reads of the same files hold equal arrays (labels, offsets,
    weights, uids, shards, entity indices and vocabs, id columns, index maps
    and intercepts)."""
    da, db = a.dataset, b.dataset
    for name in ("labels", "offsets", "weights"):
        assert torch.equal(getattr(da, name), getattr(db, name)), name
    assert np.array_equal(da.unique_ids, db.unique_ids)
    assert set(da.feature_shards) == set(db.feature_shards)
    for k, v in da.feature_shards.items():
        assert torch.equal(v, db.feature_shards[k]), k
    assert set(da.entity_idx) == set(db.entity_idx)
    for t, v in da.entity_idx.items():
        assert torch.equal(v, db.entity_idx[t]) and np.array_equal(
            da.entity_vocabs[t], db.entity_vocabs[t]), t
    assert {k: list(v) for k, v in a.index_maps.items()} == \
        {k: list(v) for k, v in b.index_maps.items()}
    assert a.intercept_indices == b.intercept_indices


def _path_check(torch, tag, kernel, plain, library, limits, nbytes: float, shape,
                slack=None) -> dict:
    """A value + gradient kernel held against its plain version on a path's
    own inputs: twice bitwise equal, the value within rel ``limits[0]``, the
    gradient within rtol 1e-4 and atol ``limits[1]`` times max|g|, each
    plus its part of ``slack`` where a product runs in TF32
    (``dev/torch_kernel_probe.tf32_slack``). Returns the errors, the largest
    error as a share of its limit, the device times of kernel, plain version
    and library call, and the bound (``nbytes`` moved, 4 operations per
    element of X)."""
    v1, g1 = kernel()[:2]
    v2, g2 = kernel()[:2]
    vr, gr = plain()[:2]
    torch.cuda.synchronize()
    assert torch.equal(v1, v2) and torch.equal(g1, g2), f"{tag}: not bitwise repeatable"
    vtol, gshare = limits
    v_slack, g_slack = (0.0, 0.0) if slack is None else slack[:2]
    gmax = float(gr.abs().max())
    value_err = abs(float(v1) - float(vr))
    value_limit = vtol * abs(float(vr)) + v_slack
    g_err = (g1.double() - gr.double()).abs()
    g_limit = 1e-4 * gr.double().abs() + gshare * gmax + g_slack
    share = max(value_err / value_limit, float((g_err / g_limit).max()))
    assert value_err <= value_limit, \
        f"{tag}: value off its plain version by {value_err} > {value_limit}"
    assert bool((g_err <= g_limit).all()), \
        f"{tag}: gradient off its plain version by {float(g_err.max())} (max |g| {gmax}, " \
        f"{share:.3g} of its limit)"
    bound, by = _bound_ms(nbytes, 4.0 * shape[0] * shape[1])
    return {"shape": list(shape), "max_abs_err": float(g_err.max()), "max_abs_gradient": gmax,
            "value_rel_err": value_err / abs(float(vr)), "limits": list(limits),
            "tf32_slack": slack is not None, "worst_err_share_of_limit": share,
            "ms": _device_ms(torch, kernel), "plain_ms": _device_ms(torch, plain),
            "bound_ms": bound, "bound_by": by, "library_ms": _device_ms(torch, library)}


def _reduce_entry(torch, tag, partials, reduce, reference) -> dict:
    """The ordered reduction of per-block partials (value, Σr or None, grad
    [blocks, d]): ``partials`` launches the partials kernel, ``reduce`` the
    reduction kernel on what it wrote; an evaluation launches both. The
    reduction's sums must be bitwise the order model's over those partials
    (``fused_glm.reduce_partials_in_order``: f32 adds on the card in the
    kernel's order), and within the worst case of two f32 orders of the same
    terms, 2·blocks·2^-24·Σ|terms|, of the plain sums (near an optimum the
    gradient is what is left of a cancellation). ``ms`` is the reduction's
    own cost, the evaluation's time less the partials' (both by graph
    replay), beside ``alone_ms``, the reduction kernel alone on fixed
    partials; the bound, plain and library times are those of summing the
    same partials."""
    from photon_ml_torch.ops import fused_glm

    parts = partials()
    got = reduce(*parts)
    order = fused_glm.reduce_partials_in_order(*parts)
    want = reference(*parts)
    torch.cuda.synchronize()
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, order)), \
        f"{tag}: the kernel's sums are not its order's"
    blocks, d = parts[2].shape
    share = 2.0 * blocks * 2.0 ** -24
    g_err = (got[1] - want[1]).abs()
    v_err = abs(float(got[0] - want[0]))
    assert bool((g_err <= share * parts[2].abs().sum(dim=0)).all()) \
        and v_err <= share * float(parts[0].abs().sum()), \
        f"{tag}: off its plain sums by {float(g_err.max())} (value {v_err})"
    err = max(float(g_err.max()), v_err)
    bound, by = _bound_ms(4.0 * (blocks + 1) * (d + 2), float(blocks * (d + 2)))
    sums = [p for p in parts if p is not None]  # the same sums as PyTorch calls
    whole_ms = _device_ms(torch, lambda: reduce(*partials()))
    partials_ms = _device_ms(torch, partials)
    return {"shape": [blocks, d], "blocks": blocks, "max_abs_err": err, "order_bitwise": True,
            "ms": whole_ms - partials_ms, "whole_ms": whole_ms, "partials_ms": partials_ms,
            "alone_ms": _device_ms(torch, lambda: reduce(*parts)),
            "plain_ms": _device_ms(torch, lambda: reference(*parts)), "bound_ms": bound,
            "bound_by": by, "library_ms": _device_ms(torch, lambda: [torch.sum(p, dim=0)
                                                                     for p in sums])}


def _driver_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 8: the three drivers end to end on Avro, printing as it goes.
    Returns, for each kernel this path runs, its launches there (the counts
    set to 0 just before each driver and read just after), the evaluations
    that launched it, and its check against its plain version on the
    path's own inputs (read back from the Avro the phase wrote), with times."""
    from dev import torch_kernel_probe
    from photon_ml_torch.algorithm import coordinates
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver, glm_driver
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.io import avro_native
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
    from photon_ml_torch.io.index_map import INTERCEPT_KEY, IndexMap, feature_key
    from photon_ml_torch.io.model_io import load_game_model, read_scores
    from photon_ml_torch.ops import fused_glm, objective, packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.util.timed import timing_summary

    cfg = DRIVERS
    _log(f"driver phase rows (cut from the flagship's, widths kept): GAME {cfg['game_rows']} "
         f"training + {cfg['validation_rows']} validation rows (flagship 2^17), {cfg['users']} "
         f"users and {cfg['items']} items (flagship 2000 and 1500); GLM {cfg['glm_rows']} + "
         f"{cfg['glm_validation_rows']} rows (bench.py 2^18); widths global 255 + intercept, "
         f"perEntity 16, GLM 511 + intercept")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # tensors earlier phases still hold
    path = {}
    evaluations = {"fused": 0, "packed": 0}
    loss = LogisticLoss()
    avro_native.fallbacks = 0  # every driver read below must take the native decoder
    with tempfile.TemporaryDirectory(prefix="photon-drivers-") as tmp:
        tmp = Path(tmp)
        # a. TrainingExample Avro from --seed with the port's writer (the
        # training set in two part files: the date-range run reads one a day)
        n, nv = cfg["game_rows"], cfg["validation_rows"]
        ng, ngv, dg = cfg["glm_rows"], cfg["glm_validation_rows"], cfg["glm_d"]
        game_pre, glm_pre = _prewritten("drivers-game"), _prewritten("drivers-glm")
        if game_pre is not None and glm_pre is not None:
            for sub in ("game", "glm"):
                shutil.copytree(game_pre["dir"] / sub, tmp / sub)
            part_s, glm_s = game_pre["part_seconds"], glm_pre["part_seconds"]
            how = (f"written in the background by {game_pre['workers']} processes while phases "
                   f"3-7b ran, a part file a process")
        else:  # the GAME and GLM files written at once, a process each

            jobs, glm_jobs = _driver_avro_jobs(np, seed, tmp)
            with _processes().Pool(len(jobs) + len(glm_jobs)) as pool:
                game_s = pool.map_async(_write_game_part, jobs)
                glm_s = pool.map(_write_glm_part, glm_jobs)
                part_s = game_s.get()
            how = "written by a process a part file"
        write_s = {"game training": sum(part_s[:2]), "game validation": part_s[2],
                   "glm training": glm_s[0], "glm validation": glm_s[1]}
        if "dir" in _SHARED:  # phase 18's drivers read the same Avro
            for sub in ("game", "glm"):
                shutil.copytree(tmp / sub, _SHARED["dir"] / "drivers" / sub, dirs_exist_ok=True)
            _SHARED["drivers_avro"] = _SHARED["dir"] / "drivers"
        rows_written = {"game training": n, "game validation": nv, "glm training": ng,
                        "glm validation": ngv}
        _log(f"Avro write (port's pure-Python codec, {how}; a part's writer seconds): "
             + ", ".join(f"{k} {rows_written[k]} records in {v:.2f} s "
                         f"({rows_written[k] / v:.0f} records/s)" for k, v in write_s.items()))

        # b. the GLM driver: B1 on every evaluation, the text model reloads
        value_and_gradient = objective.GLMObjective.value_and_gradient

        def counted_evaluation(self, coefficients, batch):
            evaluations["fused"] += int(self._kernel_enabled(batch))
            return value_and_gradient(self, coefficients, batch)

        objective.GLMObjective.value_and_gradient = counted_evaluation
        fused_glm.launches = fused_glm.reduce_launches = 0
        t0 = time.perf_counter()
        try:
            glm = glm_driver.main([
                "--input-data-path", str(tmp / "glm/train"),
                "--validation-data-path", str(tmp / "glm/validation"),
                "--output-dir", str(tmp / "glm/out"), "--task-type", "LOGISTIC_REGRESSION",
                "--regularization-weights", "1,10", "--optimizer", "LBFGS",
                "--max-iterations", "50"], device=dev)
            torch.cuda.synchronize()
        finally:
            objective.GLMObjective.value_and_gradient = value_and_gradient
        glm_s = time.perf_counter() - t0
        glm_times = timing_summary()
        fused_launches = {"fused_glm": fused_glm.launches,
                          "fused_glm_reduce": fused_glm.reduce_launches}
        assert fused_launches["fused_glm"] == evaluations["fused"] > 0 \
            and fused_launches["fused_glm_reduce"] == evaluations["fused"], \
            (fused_launches, evaluations)
        assert glm.stage.name == "VALIDATED" and glm.best_lambda in (1.0, 10.0)
        imap = IndexMap.from_keys({feature_key(f"f{j}", "") for j in range(dg - 1)},
                                  add_intercept=True)
        for lam, model in glm.models.items():
            w = model.coefficients.means.cpu().numpy()
            lines = (tmp / "glm/out/models-text" / f"{lam}.txt").read_text().splitlines()
            assert len(lines) == dg == w.shape[0]
            for line in lines:
                name, term, value = line.split("\t")
                assert float(value) == float(w[imap.get_index(feature_key(name, term))]), line
        assert imap.get_index(INTERCEPT_KEY) == dg - 1
        aucs = {lam: m["AUC"] for lam, m in glm.validation_metrics.items()}
        assert all(0.6 < a <= 1.0 for a in aucs.values()), aucs
        _log(f"GLM driver ({card}): {glm_s:.2f} s, {fused_launches['fused_glm']} fused_glm "
             f"launches for {evaluations['fused']} evaluations, validation AUC "
             f"{json.dumps(aucs)}, best λ {glm.best_lambda}; stages "
             + json.dumps({k: round(v['total'], 4) for k, v in glm_times.items()}))

        # B1 on the GLM driver's own batch, read back from its Avro, at each
        # λ's trained coefficients
        read = read_merged(tmp / "glm/train",
                           {"features": FeatureShardConfiguration(feature_bags=("features",))},
                           device=dev).dataset
        batch = LabeledPointBatch(features=read.feature_shards["features"], labels=read.labels,
                                  offsets=read.offsets, weights=read.weights)
        x = batch.features
        assert tuple(x.shape) == (ng, dg), x.shape
        r = torch.rand(ng, device=dev)
        for lam, model in sorted(glm.models.items()):
            w = model.coefficients.means.float()
            # the kernel computes the data term; the driver's L2 term is added
            # after it, and at the optimum would cancel X'r down to noise
            kw = dict(l2_weight=0.0)
            check = _path_check(
                torch, f"fused_glm on the GLM driver's batch, λ={lam}",
                lambda: fused_glm.fused_value_and_gradient(loss, w, batch, **kw),
                lambda: fused_glm.fused_value_and_gradient_reference(loss, w, batch, **kw),
                lambda: (torch.matmul(x, w), torch.matmul(r, x)), (1e-5, 1e-4),
                ng * dg * 4 + 12 * ng + 8 * dg + 8, x.shape)
            _log(f"fused_glm on the GLM driver's batch [{ng}, {dg}] λ={lam} ({card}): "
                 + json.dumps(check))
            if lam == glm.best_lambda:
                path["fused_glm"] = dict(check, launches=fused_launches["fused_glm"],
                                         evaluations=evaluations["fused"], reg_weight=lam)
                glm_args = (loss, x, batch.labels.float(), batch.offsets.float(),
                            batch.weights.float(), w, None)
                path["fused_glm_reduce"] = dict(
                    _reduce_entry(torch, "fused_glm_reduce on the GLM driver's batch",
                                  lambda: fused_glm.fused_partials(*glm_args),
                                  fused_glm.reduce_partials,
                                  fused_glm.reduce_partials_reference),
                    launches=fused_launches["fused_glm_reduce"],
                    evaluations=evaluations["fused"])
        del read, batch, x, r, glm_args

        # c. the GAME training driver: every fixed-effect update launches the
        # packed kernel; the best model beats its fixed effect alone
        for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
            setattr(packed_glm, name, 0)
        per_update = []
        update = coordinates.FixedEffectCoordinate.update_model

        def counted(self, *args, **kw):
            before = packed_glm.packed_launches
            out = update(self, *args, **kw)
            per_update.append(packed_glm.packed_launches - before)
            return out

        packed_evaluation = objective.PackedBoundObjective.value_and_grad

        def counted_packed(self, w):
            evaluations["packed"] += int(self.aux is not None)
            return packed_evaluation(self, w)

        coordinates.FixedEffectCoordinate.update_model = counted
        objective.PackedBoundObjective.value_and_grad = counted_packed
        shards = ["--feature-shard-configurations",
                  "name=global,feature.bags=features,intercept=true",
                  "--feature-shard-configurations",
                  "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
        re_spec = ("feature.shard=per_entity,reg.weights=1,optimizer=NEWTON,max.iter=10,"
                   "random.effect.type=")
        t0 = time.perf_counter()
        try:
            game = game_training_driver.main([
                "--input-data-path", str(tmp / "game/train"),
                "--validation-data-path", str(tmp / "game/validation"),
                "--root-output-dir", str(tmp / "game/out"), "--task-type",
                "LOGISTIC_REGRESSION", *shards,
                "--coordinate-configurations",
                "name=fixed,feature.shard=global,reg.weights=1|10,max.iter=10",
                "--coordinate-configurations", f"name=per_user,{re_spec}userId",
                "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
                "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
            torch.cuda.synchronize()
        finally:
            coordinates.FixedEffectCoordinate.update_model = update
            objective.PackedBoundObjective.value_and_grad = packed_evaluation
        game_s = time.perf_counter() - t0
        packed_launches = {"packed_glm": packed_glm.packed_launches,
                           "packed_glm_reduce": packed_glm.reduce_launches}
        assert len(per_update) == 2 * 2 and min(per_update) > 0, per_update
        assert packed_launches["packed_glm"] == evaluations["packed"] == sum(per_update) \
            and packed_launches["packed_glm_reduce"] == evaluations["packed"], \
            (packed_launches, evaluations, per_update)
        assert game["num_configurations"] == 2
        # configuration 0 starts cold (the later one warm-starts from it), so
        # its first update scores the fixed effect alone, random effects at 0
        fe_alone = game["metric_history"][0]["metrics"][0]
        assert fe_alone["iteration"] == 0 and fe_alone["coordinate"] == "fixed"
        assert game["best_metric"] > fe_alone["validate:AUC"] > 0.5, (game["best_metric"],
                                                                     fe_alone)
        _log(f"GAME training driver ({card}): {game_s:.2f} s, fixed-effect updates launched "
             f"{per_update} packed kernels ({evaluations['packed']} evaluations), validation AUC {game['best_metric']:.6f} (λ "
             f"{game['best_reg_weights']}) against the fixed effect alone "
             f"{fe_alone['validate:AUC']:.6f}; stages "
             + json.dumps({k: round(v["total"], 4) for k, v in game["timings"].items()}))
        read_s = game["timings"]["avro decode"]["total"]

        # d. the scoring driver on the saved best model
        t0 = time.perf_counter()
        scored = game_scoring_driver.main([
            "--input-data-path", str(tmp / "game/validation"),
            "--model-input-dir", str(tmp / "game/out/best"),
            "--output-dir", str(tmp / "game/scored"), "--evaluators", "AUC", *shards],
            device=dev)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        score_times = timing_summary()
        avro_scores = np.asarray([r["predictionScore"]
                                  for r in read_scores(tmp / "game/scored/scores")])
        maps = IndexMap.load_directory(tmp / "game/out/index-maps")
        model = load_game_model(tmp / "game/out/best", maps, device=dev)
        vocabs = {m.random_effect_type: m.entity_keys for m in model.models.values()
                  if hasattr(m, "entity_keys")}
        shard_cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
                     "per_entity": FeatureShardConfiguration(feature_bags=("perEntityFeatures",),
                                                             has_intercept=False)}
        ds = read_merged(tmp / "game/validation", shard_cfg, index_maps=maps,
                         random_effect_id_columns=("itemId", "userId"), entity_vocabs=vocabs,
                         device=dev).dataset
        in_process = (model.score(ds) + ds.offsets).cpu().numpy()
        assert avro_scores.shape == (nv,) and np.isfinite(avro_scores).all()
        # the scores are written as the doubles their f32 values are: bitwise
        assert np.array_equal(avro_scores, in_process.astype(np.float64)), \
            float(np.abs(avro_scores - in_process).max())
        auc_file = local_metrics.area_under_roc_curve(avro_scores, ds.host_array("labels"))
        # the saved model drops coefficients under 1e-4 (the reference's
        # sparsity threshold), so its AUC may move in the last digits
        gap = abs(scored["evaluations"]["AUC"] - game["best_metric"])
        assert gap <= 1e-4 and abs(auc_file - scored["evaluations"]["AUC"]) <= 1e-12, \
            (scored["evaluations"], game["best_metric"], auc_file)
        _log(f"GAME scoring driver ({card}): {score_s:.2f} s, {nv} scores bitwise equal to the "
             f"loaded model's in-process scores, AUC {scored['evaluations']['AUC']:.6f} (training "
             f"driver's validation AUC {game['best_metric']:.6f}, gap {gap:.3g}); stages "
             + json.dumps({k: round(v["total"], 4) for k, v in score_times.items()}))

        # e. the GAME training driver again, the per-user effect projected
        # (INDEX_MAP) with elastic-net (OWL-QN) lanes, and the scoring driver
        # on its saved model: the same checks as the run above
        for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
            setattr(packed_glm, name, 0)
        t0 = time.perf_counter()
        proj = game_training_driver.main([
            "--input-data-path", str(tmp / "game/train"),
            "--validation-data-path", str(tmp / "game/validation"),
            "--root-output-dir", str(tmp / "game/out-projected"), "--task-type",
            "LOGISTIC_REGRESSION", *shards,
            "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1|10,max.iter=10",
            "--coordinate-configurations",
            "name=per_user,feature.shard=per_entity,reg.weights=1,max.iter=10,"
            "projector=INDEX_MAP,reg.alpha=0.5,random.effect.type=userId",
            "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
        torch.cuda.synchronize()
        proj_s = time.perf_counter() - t0
        proj_launches = {"packed_glm": packed_glm.packed_launches,
                         "packed_glm_reduce": packed_glm.reduce_launches}
        assert proj_launches["packed_glm"] > 0 \
            and proj_launches["packed_glm_reduce"] == proj_launches["packed_glm"], proj_launches
        proj_fe = proj["metric_history"][0]["metrics"][0]
        assert proj_fe["coordinate"] == "fixed" and proj["best_metric"] > \
            proj_fe["validate:AUC"] > 0.5, (proj["best_metric"], proj_fe)
        game_scoring_driver.main([
            "--input-data-path", str(tmp / "game/validation"),
            "--model-input-dir", str(tmp / "game/out-projected/best"),
            "--output-dir", str(tmp / "game/scored-projected"), "--evaluators", "AUC",
            *shards], device=dev)
        proj_scores = np.asarray([r["predictionScore"]
                                  for r in read_scores(tmp / "game/scored-projected/scores")])
        proj_maps = IndexMap.load_directory(tmp / "game/out-projected/index-maps")
        proj_model = load_game_model(tmp / "game/out-projected/best", proj_maps, device=dev)
        proj_ds = read_merged(tmp / "game/validation", shard_cfg, index_maps=proj_maps,
                              random_effect_id_columns=("itemId", "userId"),
                              entity_vocabs={m.random_effect_type: m.entity_keys
                                             for m in proj_model.models.values()
                                             if hasattr(m, "entity_keys")},
                              device=dev).dataset
        proj_in_process = (proj_model.score(proj_ds) + proj_ds.offsets).cpu().numpy()
        assert np.array_equal(proj_scores, proj_in_process.astype(np.float64)), \
            float(np.abs(proj_scores - proj_in_process).max())
        _log(f"GAME training driver, per-user INDEX_MAP with elastic-net lanes ({card}): "
             f"{proj_s:.2f} s, {proj_launches['packed_glm']} packed kernels, validation AUC "
             f"{proj['best_metric']:.6f} (λ {proj['best_reg_weights']}) against the fixed "
             f"effect alone {proj_fe['validate:AUC']:.6f}; its {nv} Avro scores bitwise equal "
             f"to the loaded model's in-process scores")
        del proj_model, proj_ds

        # the packed kernel on the GAME driver's fixed-effect inputs, read
        # back from its training Avro, at the best model's coefficients with
        # the random effects' scores as residual offsets (the last sweep's)
        ds = read_merged(tmp / "game/train", shard_cfg, index_maps=maps,
                         random_effect_id_columns=("itemId", "userId"), entity_vocabs=vocabs,
                         device=dev).dataset
        x = ds.feature_shards["global"]
        assert tuple(x.shape) == (n, cfg["d_fe"] + 1), x.shape
        w = model.get("fixed").glm.coefficients.means.float().contiguous()
        aux = packed_glm.pack_aux(ds.labels, ds.offsets + model.score(ds) - x @ w, ds.weights)
        r = torch.rand(n, device=dev)
        check = _path_check(
            torch, "packed_glm on the GAME driver's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
            lambda: (torch.matmul(x, w), torch.matmul(r, x)),
            torch_kernel_probe.limits("float32"),
            x.shape[0] * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8, x.shape)
        path["packed_glm"] = dict(check, launches=packed_launches["packed_glm"],
                                  evaluations=evaluations["packed"],
                                  projected_run_launches=proj_launches["packed_glm"])
        fe_args = (loss, x, aux, None, None, None, w, None, False, "fma", "fma")
        path["packed_glm_reduce"] = dict(
            _reduce_entry(torch, "packed_glm_reduce on the GAME driver's fixed effect",
                          lambda: packed_glm.launch_partials(*fe_args),
                          packed_glm.reduce_partials, packed_glm.reduce_partials_reference),
            launches=packed_launches["packed_glm_reduce"], evaluations=evaluations["packed"],
            projected_run_launches=proj_launches["packed_glm_reduce"])
        _log(f"packed_glm on the GAME driver's fixed effect {list(x.shape)} ({card}): "
             + json.dumps(path["packed_glm"]))
        del ds, x, aux, r, fe_args
        _log(f"driver phase ({card}): Avro decode {n / read_s:.0f} records/s ({n} GAME training "
             f"records of 272 features in {read_s:.2f} s), write "
             f"{rows_written['game training'] / write_s['game training']:.0f} records/s; peak "
             f"device memory {(torch.cuda.max_memory_allocated() - resident) / 2**20:.1f} MiB "
             f"above the {resident / 2**20:.1f} MiB earlier phases still hold")

        # g. the native decoder against the Python codec on the same files (the
        # validation sets: the Python codec reads about 300-500 records/s):
        # array for array, with each codec's records per second
        game_cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
                    "per_entity": FeatureShardConfiguration(
                        feature_bags=("perEntityFeatures",), has_intercept=False)}
        glm_cfg = {"features": FeatureShardConfiguration(feature_bags=("features",))}
        codec_rates = {}
        for label, where, cfgs, ids, rows in (
                ("GAME validation", tmp / "game/validation", game_cfg, ("itemId", "userId"), nv),
                ("GLM validation", tmp / "glm/validation", glm_cfg, (), ngv)):
            reads, seconds = [], []
            for native in (True, False):
                if not native:
                    os.environ["PHOTON_NO_NATIVE_AVRO"] = "1"
                t0 = time.perf_counter()
                try:
                    reads.append(read_merged(where, cfgs, random_effect_id_columns=ids,
                                             device=dev))
                finally:
                    os.environ.pop("PHOTON_NO_NATIVE_AVRO", None)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            _same_read(torch, np, *reads)
            codec_rates[label] = {"native_records_per_s": rows / seconds[0],
                                  "python_records_per_s": rows / seconds[1],
                                  "native_s": seconds[0], "python_s": seconds[1]}
            del reads
        assert avro_native.fallbacks == 0, avro_native.fallbacks
        _log(f"Avro read, native decoder against the Python codec ({card}): the datasets equal "
             f"array for array; " + json.dumps(codec_rates))

        # h. the GAME training driver with an MF coordinate (user × item, k=16)
        # beside the fixed effect, then the scoring driver on its saved model
        for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
            setattr(packed_glm, name, 0)
        t0 = time.perf_counter()
        mf_run = game_training_driver.main([
            "--input-data-path", str(tmp / "game/train"),
            "--validation-data-path", str(tmp / "game/validation"),
            "--root-output-dir", str(tmp / "game/out-mf"), "--task-type", "LOGISTIC_REGRESSION",
            *shards, "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--coordinate-configurations",
            "name=mf,mf.row.effect.type=userId,mf.col.effect.type=itemId,mf.latent.factors=16,"
            "reg.weights=10,max.iter=10",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
        torch.cuda.synchronize()
        mf_s = time.perf_counter() - t0
        mf_launches = {"packed_glm": packed_glm.packed_launches,
                       "packed_glm_reduce": packed_glm.reduce_launches}
        assert mf_launches["packed_glm"] > 0 \
            and mf_launches["packed_glm_reduce"] == mf_launches["packed_glm"], mf_launches
        assert os.path.isdir(tmp / "game/out-mf/best/matrix-factorization/mf/row-latent-factors")
        game_scoring_driver.main([
            "--input-data-path", str(tmp / "game/validation"),
            "--model-input-dir", str(tmp / "game/out-mf/best"),
            "--output-dir", str(tmp / "game/scored-mf"), "--evaluators", "AUC", *shards],
            device=dev)
        mf_scores = np.asarray([r["predictionScore"]
                                for r in read_scores(tmp / "game/scored-mf/scores")])
        mf_maps = IndexMap.load_directory(tmp / "game/out-mf/index-maps")
        mf_model = load_game_model(tmp / "game/out-mf/best", mf_maps, device=dev)
        mf_sub = mf_model.get("mf")
        mf_ds = read_merged(tmp / "game/validation", shard_cfg, index_maps=mf_maps,
                            random_effect_id_columns=("itemId", "userId"),
                            entity_vocabs={"userId": mf_sub.row_keys, "itemId": mf_sub.col_keys},
                            device=dev).dataset
        mf_in_process = (mf_model.score(mf_ds) + mf_ds.offsets).cpu().numpy()
        assert np.array_equal(mf_scores, mf_in_process.astype(np.float64)), \
            float(np.abs(mf_scores - mf_in_process).max())
        _log(f"GAME training driver with an MF coordinate (userId × itemId, k=16) ({card}): "
             f"{mf_s:.2f} s, {mf_launches['packed_glm']} packed kernels, validation AUC "
             f"{mf_run['best_metric']:.6f}, factors {list(mf_sub.row_factors.shape)} and "
             f"{list(mf_sub.col_factors.shape)}; the scoring driver's {nv} Avro scores bitwise "
             f"equal to the loaded model's in-process scores; stages "
             + json.dumps({k: round(v["total"], 4) for k, v in mf_run["timings"].items()}))
        del mf_model, mf_ds, mf_sub

        # i. --input-date-range over two daily directories equals the same
        # part files read as one directory
        for day, part in ((1, "part-00000.avro"), (2, "part-00001.avro")):
            daily = tmp / f"game/days/daily/2026/01/{day:02d}"
            daily.mkdir(parents=True)
            shutil.copy(tmp / "game/train" / part, daily / part)
        dated = {}
        for label, extra in (("one directory", ["--input-data-path", str(tmp / "game/train")]),
                             ("date range", ["--input-data-path", str(tmp / "game/days"),
                                             "--input-date-range", "20260101-20260102"])):
            dated[label] = game_training_driver.main([
                *extra, "--validation-data-path", str(tmp / "game/validation"),
                "--root-output-dir", str(tmp / f"game/out-{label.replace(' ', '-')}"),
                "--task-type", "LOGISTIC_REGRESSION", *shards, "--coordinate-configurations",
                "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
                "--coordinate-configurations", f"name=per_user,{re_spec}userId",
                "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
        best_files = sorted(p.relative_to(tmp / "game/out-one-directory/best")
                            for p in (tmp / "game/out-one-directory/best").rglob("*")
                            if p.is_file())
        for f in best_files:
            assert (tmp / "game/out-one-directory/best" / f).read_bytes() == \
                (tmp / "game/out-date-range/best" / f).read_bytes(), f
        assert dated["date range"]["best_metric"] == dated["one directory"]["best_metric"]
        _log(f"GAME training driver with --input-date-range 20260101-20260102 over two daily "
             f"directories ({card}): validation AUC {dated['date range']['best_metric']:.6f}, "
             f"its {len(best_files)} model files byte-identical to the one-directory run's")
        assert avro_native.fallbacks == 0, avro_native.fallbacks

        # j. the GAME training driver at the flagship's rows, uncut: Avro
        # written by a pool of the port's pure-Python writers, one part each
        path["packed_glm"].update(mf_run_launches=mf_launches["packed_glm"])
        path["packed_glm_reduce"].update(mf_run_launches=mf_launches["packed_glm_reduce"])
        path["packed_glm"]["flagship_run"] = _flagship_driver_run(
            torch, np, seed, dev, tmp, card, shards, re_spec)
        assert avro_native.fallbacks == 0, avro_native.fallbacks

        # f. the sparse drivers: sparse Avro with a compact random effect,
        # LibSVM into the GLM and GAME drivers
        t0 = time.perf_counter()
        sparse = _sparse_driver_slice(torch, np, seed, dev, tmp, card)
        _log(f"sparse drivers: {time.perf_counter() - t0:.2f} s")
    assert avro_native.fallbacks == 0, f"{avro_native.fallbacks} reads left the native decoder"
    path["fused_glm"]["libsvm_run_launches"] = sparse["GLM, LibSVM"]["fused_glm"]
    path["fused_glm_reduce"]["libsvm_run_launches"] = sparse["GLM, LibSVM"]["fused_glm_reduce"]
    # each run's launches and the checks of G1 on its own inputs; the row and
    # segment counters include compact scoring's launches, which stand apart
    gather = {k: v for k, v in sparse.items() if "compact" in v}
    path["sparse_gather"] = {
        "launches": sum(v["rows"] + v["segments"] - v["compact"] for v in gather.values()),
        "runs": {k: {c: v[c] for c in ("rows", "segments", "compact")} for k, v in
                 gather.items()},
        "checks": [c for v in gather.values() for c in v["checks"]]}
    path["sparse_gather_chunks"] = {
        "launches": sum(v["chunks"] for v in gather.values()),
        "checks": [c for v in gather.values() for c in v["checks"] if c["chunk_rows"]]}
    path["sparse_gather_compact"] = {
        "launches": sum(v["compact"] for v in gather.values()),
        "checks": [v["compact_check"] for v in gather.values() if "compact_check" in v]}
    return path


def _flagship_driver_run(torch, np, seed: int, dev, tmp: Path, card: str, shards,
                         re_spec: str) -> dict:
    """Phase 8's GAME training driver at the flagship's rows, uncut (2^17
    training and 2^15 validation rows at the flagship widths): the Avro
    written by a pool of processes, each running the port's pure-Python
    writer on one part file; the driver's stages printed (``util/timed``);
    the packed kernel held against its plain version on the run's own
    fixed-effect inputs, read back from its Avro. Returns that check with
    the run's launches."""
    from dev import torch_kernel_probe
    from photon_ml_torch.cli import game_training_driver
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss

    # the global bag one narrower than the flagship's d = 256: the driver
    # appends the intercept, as the 8,192-row runs' 255 features do
    avro = _flagship_avro(np, seed, tmp, size="uncut")
    n, nv, workers, write_s = avro["n"], avro["held_out"], avro["workers"], avro["write_seconds"]
    written = (f"written in the background while phases 3-7b ran ({write_s:.2f} s of writer "
               f"time over {len(avro.get('part_seconds', ()))} part files)" if avro["background"] else
               f"written in {write_s:.2f} s ({(n + nv) / write_s:.0f} records/s)")
    for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
        setattr(packed_glm, name, 0)
    t0 = time.perf_counter()
    run = game_training_driver.main([
        "--input-data-path", str(avro["train"]),
        "--validation-data-path", str(avro["validation"]),
        "--root-output-dir", str(tmp / "flagship/out"), "--task-type", "LOGISTIC_REGRESSION",
        *shards, "--coordinate-configurations",
        "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
        "--coordinate-configurations", f"name=per_user,{re_spec}userId",
        "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
        "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"packed_glm": packed_glm.packed_launches,
                "packed_glm_reduce": packed_glm.reduce_launches}
    assert launches["packed_glm"] > 0 \
        and launches["packed_glm_reduce"] == launches["packed_glm"], launches
    fe_alone = run["metric_history"][0]["metrics"][0]
    assert fe_alone["coordinate"] == "fixed" and run["best_metric"] > \
        fe_alone["validate:AUC"] > 0.5, (run["best_metric"], fe_alone)
    decode = run["timings"]["avro decode"]["total"]
    _log(f"GAME training driver at the flagship's rows, uncut ({card}): {n} training + {nv} "
         f"validation rows {written} by {workers} processes of the port's pure-Python writer, "
         f"training run "
         f"{run_s:.2f} s, {launches['packed_glm']} packed kernels, validation AUC "
         f"{run['best_metric']:.6f} against the fixed effect alone "
         f"{fe_alone['validate:AUC']:.6f}; native Avro decode {(n + nv) / decode:.0f} records/s; "
         f"stages " + json.dumps({k: round(v["total"], 4) for k, v in run["timings"].items()}))
    maps = IndexMap.load_directory(tmp / "flagship/out/index-maps")
    model = load_game_model(tmp / "flagship/out/best", maps, device=dev)
    cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
           "per_entity": FeatureShardConfiguration(feature_bags=("perEntityFeatures",),
                                                   has_intercept=False)}
    ds = read_merged(avro["train"], cfg, index_maps=maps,
                     random_effect_id_columns=("itemId", "userId"),
                     entity_vocabs={m.random_effect_type: m.entity_keys
                                    for m in model.models.values() if hasattr(m, "entity_keys")},
                     device=dev).dataset
    x = ds.feature_shards["global"]
    assert tuple(x.shape) == (n, avro["d_fe"] + 1), x.shape
    w = model.get("fixed").glm.coefficients.means.float().contiguous()
    aux = packed_glm.pack_aux(ds.labels, ds.offsets + model.score(ds) - x @ w, ds.weights)
    loss = LogisticLoss()
    r = torch.rand(n, device=dev)
    check = _path_check(
        torch, "packed_glm on the flagship driver run's fixed effect",
        lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
        lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
        lambda: (torch.matmul(x, w), torch.matmul(r, x)), torch_kernel_probe.limits("float32"),
        x.shape[0] * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8, x.shape)
    _log(f"packed_glm on the flagship driver run's fixed effect {list(x.shape)} ({card}): "
         + json.dumps(check))
    return dict(check, launches=launches["packed_glm"],
                reduce_launches=launches["packed_glm_reduce"], write_seconds=write_s,
                run_seconds=run_s, timings={k: v["total"] for k, v in run["timings"].items()})


#: phase 9's shapes: bench.py:721 (bench_game_sweep_composed), none cut: n = 2^16 rows of
#: 16 Zipf columns (γ = 24) over d = 10^6, values N(0,1)/4, 2000 users, linear labels
#: (row sum + 0.1 noise), 2^14 held-out rows over the same users; the per-user effect
#: lives on the same sparse shard as the fixed effect, so it is compact. ``small`` is
#: the card-vs-CPU problem.
SPARSE_GAME = dict(n=1 << 16, d=1_000_000, per_row=16, users=2000, held_out=1 << 14,
                   hot_cols=256, sweeps=4, small=dict(n=4096, d=1 << 16, users=64))
#: the scaled fit's held-out RMSE after its last sweep and after its first
#: update (the fixed effect alone) in the JAX package on the CPU at this
#: phase's full size, float32, by seed (``python -m tests.torch_sparse_game_witness``):
#: the fit overfits there too, its RMSE ending above the fixed effect's
SCALED_FIT_REFERENCE = {0: dict(held_out_rmse=5.0303113442097045,
                                fe_alone_held_out_rmse=4.851650575806711)}


def _sparse_game_arrays(np, seed: int, n: int, d: int, per_row: int, users: int,
                        held_out: int = 0):
    """bench.py:721's data from ``seed + 13`` (bench.py's own seed at seed 0):
    (train, held) dicts of COO entries, labels and user keys."""
    rng = np.random.default_rng(seed + 13)
    total = n + held_out
    cols = _zipf_cols(np, rng, total * per_row, d)
    vals = (rng.normal(size=total * per_row) / np.sqrt(per_row)).astype(np.float32)
    y = vals.reshape(total, per_row).sum(axis=1) + 0.1 * rng.normal(size=total).astype(
        np.float32)
    keys = np.array([f"u{i}" for i in rng.integers(0, users, size=total)])

    def part(lo, hi):
        sl = slice(lo * per_row, hi * per_row)
        return {"rows": np.repeat(np.arange(hi - lo), per_row), "cols": cols[sl],
                "vals": vals[sl], "labels": y[lo:hi], "users": keys[lo:hi], "n": hi - lo}

    return part(0, n), part(n, total)


def _sparse_game_dataset(part, d: int, device, dtype=None, vocabs=None, policy=None):
    import numpy as np

    from photon_ml_torch.data.game_data import build_game_dataset
    from photon_ml_torch.data.sparse_batch import SparseShard

    dtype = dtype or np.float32
    shard = SparseShard(rows=part["rows"].astype(np.int64), cols=part["cols"].astype(np.int64),
                        vals=part["vals"].astype(dtype), num_samples=part["n"], feature_dim=d,
                        hybrid_policy=policy)
    return build_game_dataset(labels=part["labels"], feature_shards={"global": shard},
                              entity_keys={"user": part["users"]}, entity_vocabs=vocabs,
                              dtype=dtype, device=device)


def _sparse_game_estimator(lanes: str, sweeps: int, *, normalization: str = "NONE",
                           compute_variance: bool = False, evaluators=("RMSE",)):
    """Phase 9's GAME model: a fixed effect (L-BFGS, 10 iterations) and a
    per-user random effect (``lanes``, 10 iterations), both on ``global``,
    L2 weight 1, linear regression."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.ops.normalization import NormalizationType
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    def opt(kind, **kw):
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType[kind], max_iterations=10), l2_weight=1.0,
            **kw)

    return GameEstimator(
        task=TaskType.LINEAR_REGRESSION,
        coordinate_configs={
            "fixed": FixedEffectCoordinateConfig("global", opt("LBFGS")),
            "per_user": RandomEffectCoordinateConfig(
                "user", "global", opt(lanes, compute_variance=compute_variance,
                                      variance_mode="full"))},
        num_iterations=sweeps, normalization=NormalizationType[normalization],
        validation_evaluators=tuple(evaluators))


def _gather_counts():
    from photon_ml_torch.models import game
    from photon_ml_torch.ops import sparse_gather

    return {"rows": sparse_gather.launches, "segments": sparse_gather.segment_launches,
            "chunks": sparse_gather.chunk_launches, "compact": game.compact_launches}


def _reset_gather_counts():
    from photon_ml_torch.models import game
    from photon_ml_torch.ops import sparse_gather

    sparse_gather.launches = sparse_gather.segment_launches = sparse_gather.chunk_launches = 0
    game.compact_launches = 0


class _SweepModels:
    """The models each coordinate's ``update_model`` returns during one fit,
    by wrapping the port's methods (restored on exit): after each sweep, the
    fixed and per-user models and their coordinates."""

    def __init__(self):
        self.sweeps: list = []
        self._saved = []

    def __enter__(self):
        from photon_ml_torch.algorithm import coordinates

        latest = {}
        for cls in (coordinates.FixedEffectCoordinate, coordinates.RandomEffectCoordinate):
            fn = cls.update_model

            def recorded(coord, *args, _fn=fn, **kw):
                out = _fn(coord, *args, **kw)
                latest[coord.coordinate_id] = (coord, out[0])
                if coord.coordinate_id == "per_user":  # the last of a sweep
                    self.sweeps.append(dict(latest))
                return out

            self._saved.append((cls, fn))
            cls.update_model = recorded
        return self

    def __exit__(self, *exc):
        for cls, fn in self._saved:
            cls.update_model = fn


def _cd_objective(torch, sweep: dict, dataset) -> float:
    """The objective block coordinate descent lowers, in f64: the weighted
    squared loss of the whole model plus each coordinate's L2 penalty on its
    coefficients in the space it solves in (normalized for a normalized
    fit). Each update lowers its own block's part from its warm start, so
    the sum does not rise over the sweeps."""
    from photon_ml_torch.ops.normalization import no_normalization

    (fe_coord, fe), (re_coord, re) = sweep["fixed"], sweep["per_user"]
    margins = (fe.score_dataset(dataset) + re.score_dataset(dataset)).double() \
        + dataset.offsets.double()
    data = float((dataset.weights.double() * 0.5 * (margins - dataset.labels.double()) ** 2)
                 .sum())
    fe_norm = fe_coord.normalization or no_normalization()
    re_norm = re_coord.normalization or no_normalization()
    w = fe_norm.from_model_space(fe.glm.coefficients.means, fe_coord.intercept_index).double()
    t = re_norm.from_model_space_compact(re.coefficients, torch.as_tensor(
        re.active_cols, device=re.coefficients.device)).double()
    return data + 0.5 * fe_coord.config.l2_weight * float(w @ w) \
        + 0.5 * re_coord.config.l2_weight * float((t * t).sum())


def _sparse_game_fit(torch, label: str, estimator, dataset, held, sweeps: int,
                     reference: dict | None = None) -> dict:
    """One ``GameEstimator.fit`` of phase 9 with the gather counters set to 0
    just before and read just after: the training loss and the
    coordinate-descent objective (:func:`_cd_objective`) non-increasing over
    the sweeps; the held-out RMSE of the whole model below that of its first
    update (the fixed effect alone, the random effect at 0), or, given a
    ``reference`` (the JAX package's two RMSEs for this fit), each within 1%
    of it; seconds a sweep by coordinate.

    The scaled fit takes a reference: its blocks are regularized in
    normalized space, where this data's rare columns get large factors, so
    it fits the training rows far more closely than it predicts held-out
    ones and its held-out RMSE ends above the fixed effect's, in the JAX
    package as in the port (``SCALED_FIT_REFERENCE``)."""
    _reset_gather_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _GameTimers(torch) as timers, _SweepModels() as recorded:
        result = estimator.fit(dataset, validation_dataset=held)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _gather_counts()
    history = result.metric_history
    loss_name = next(k for k in history[0] if k.startswith("train:"))
    last = [h[loss_name] for h in history if h["coordinate"] == history[-1]["coordinate"]]
    assert len(last) == sweeps and all(math.isfinite(v) for v in last), f"{label}: {last}"
    assert all(b <= a * (1 + 1e-5) for a, b in zip(last, last[1:])), \
        f"{label}: training loss rose over the sweeps: {last}"
    objective = [_cd_objective(torch, sweep, dataset) for sweep in recorded.sweeps]
    assert len(objective) == sweeps and all(b <= a * (1 + 1e-5) for a, b in
                                            zip(objective, objective[1:])), \
        f"{label}: the coordinate-descent objective rose over the sweeps: {objective}"
    fe_alone = history[0]
    assert fe_alone["iteration"] == 0 and fe_alone["coordinate"] == "fixed"
    rmse = history[-1]["validate:RMSE"]
    assert math.isfinite(rmse), (label, rmse)
    if reference is None:
        assert rmse < fe_alone["validate:RMSE"], (label, rmse, fe_alone["validate:RMSE"])
    else:
        got = {"held_out_rmse": rmse, "fe_alone_held_out_rmse": fe_alone["validate:RMSE"]}
        for key, want in reference.items():
            assert abs(got[key] - want) <= 0.01 * want, (label, key, got[key], want)
    assert launches["compact"] > 0 and launches["rows"] + launches["segments"] > 0, launches
    known = sum(v for k, v in timers.seconds.items() if k.startswith("solve ")) \
        + timers.seconds.get("rescoring", 0.0) + timers.seconds.get("bucket builder", 0.0)
    out = {"fit": label, "seconds": seconds, "sweeps": sweeps,
           "seconds_per_sweep": (seconds - timers.seconds.get("bucket builder", 0.0)) / sweeps,
           "fe_per_sweep": timers.seconds.get("solve fixed", 0.0) / sweeps,
           "re_per_sweep": timers.seconds.get("solve per_user", 0.0) / sweeps,
           "rescoring_per_sweep": timers.seconds.get("rescoring", 0.0) / sweeps,
           "host_rest_per_sweep": (seconds - known) / sweeps,
           "bucket_builder_seconds": timers.seconds.get("bucket builder", 0.0),
           "loss_per_sweep": last, "objective_per_sweep": objective, "held_out_rmse": rmse,
           "fe_alone_held_out_rmse": fe_alone["validate:RMSE"], "launches": launches}
    _log(f"sparse GAME fit {json.dumps(out)}")
    out["result"] = result
    return out


def _compact_entry(torch, replaces: str, entries, table, check: dict) -> dict:
    """The kernels-line entry of compact scoring (G1 over the flattened
    [E, K+1] table): device and eager time of the scoring as the path calls
    it, its plain version's (a gather and an ``index_add_``), cuSPARSE's CSR
    product over the flat slots (``library_ms``, bf16 never: f32 values),
    and the bound from the bytes the function needs (each entry's value and
    slot, the row pointers, the output and each distinct slot of the table
    once) and 2 operations an entry."""
    from photon_ml_torch.models.game import score_random_effect_compact_reference

    e, k = table.shape
    flat, row_ptr, _ = entries.plan(e, k)
    n, nnz = entries.num_samples, entries.vals.numel()
    nbytes = nnz * (entries.vals.element_size() + 4) + 4 * (n + 1) + 4 * n \
        + 4 * int(torch.unique(flat).numel())
    bound, by = _bound_ms(nbytes, 2.0 * nnz)
    csr = torch.sparse_csr_tensor(row_ptr, flat, entries.vals.float(), (n, e * (k + 1)),
                                  check_invariants=False)

    def library():
        return csr @ torch.cat([table, table.new_zeros((e, 1))], dim=1).reshape(-1)

    lib = library()
    torch.cuda.synchronize()
    assert float((lib.double() - entries.score(table).double()).abs().max()) \
        <= 1e-5 * check["scale_max"] + 1e-30
    return {"name": "sparse_gather_compact", "route": "cuda",
            "source": "photon_ml_torch/csrc/sparse_gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": check["max_abs_err"],
            "ms": _device_ms(torch, lambda: entries.score(table)),
            "eager_ms": _eager_ms(torch, lambda: entries.score(table)),
            "plain_ms": _device_ms(torch, lambda: score_random_effect_compact_reference(
                table, entries.ent, entries.pos, entries.rows, entries.vals, n)),
            "bound_ms": bound, "bound_by": by, "library_ms": _device_ms(torch, library),
            "worst_err_share_of_limit": check["max_err_over_scale"] / check["rel_limit"],
            "shape": [n, nnz], "table": [e, k], "layout": "compact scoring (segment kernel)",
            "dtype": "float32", "bytes": nbytes}


def _compact_check(torch, tag: str, entries, table, rel: float = 1e-5) -> dict:
    """Compact scoring through the gather kernel, twice (bitwise equal),
    against its plain version in f64 on the same entries and table: per row
    |k - p| <= rel * sum|v * t|."""
    from photon_ml_torch.models.game import score_random_effect_compact_reference

    k1, k2 = entries.score(table), entries.score(table)
    args = (entries.ent, entries.pos, entries.rows)
    n = entries.num_samples
    plain = score_random_effect_compact_reference(table.double(), *args,
                                                  entries.vals.double(), n)
    scale = score_random_effect_compact_reference(table.double().abs(), *args,
                                                  entries.vals.double().abs(), n)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2), f"compact scoring not bitwise repeatable: {tag}"
    assert k1.dtype == torch.float32 and bool(torch.isfinite(k1).all()), tag
    err = (k1.double() - plain).abs()
    bad = int((err > rel * scale + 1e-30).sum())
    assert bad == 0, f"compact scoring off its plain version in {bad} of {n} rows: {tag}"
    return {"case": tag, "rows": n, "rel_limit": rel, "max_abs_err": float(err.max()),
            "max_err_over_scale": float((err / (scale + 1e-30)).max()),
            "scale_max": float(scale.max())}


def _batch_gather_args(batch) -> dict:
    """The ELL block, flat tail and chunk plan of a sparse batch, as its
    margins pass them to ``gather_sum``."""
    return dict(ell=(batch.ell_vals, batch.ell_cols) if batch.has_ell_view else None,
                tail=(batch.values, batch.col_indices, batch.row_ids, batch.row_ptr)
                if batch.nnz else None, chunks=batch.row_chunks)


def _fe_gather_checks(torch, tag: str, batch, w) -> list:
    """G1 as a sparse fixed effect calls it on ``batch`` (a path's own
    training batch at its fitted coefficients ``w``), each held against its
    plain version by :func:`_gather_check` (twice, bitwise equal; per row
    |k - p| <= 1e-5 sum|v w| in f64): the margins X w over the ELL block and
    flat tail with the batch's chunk plan, and the transpose Xᵀr over the
    column-sorted plan with its chunk plan (Zipf-hot columns run the chunk
    kernel), r being the squared loss's row weights at w. A hybrid batch's
    head is a dense product and not G1's, so it is not part of these."""
    from photon_ml_torch.data.sparse_batch import feature_product, transpose_plan

    n = batch.num_samples
    w = w.float().contiguous()
    margins = _gather_check(torch, f"{tag}: margins X w", w, n, **_batch_gather_args(batch))
    r = (batch.weights * (feature_product(batch, w) + batch.offsets - batch.labels)) \
        .float().contiguous()
    vals, rows, col_ptr, chunks = transpose_plan(batch)
    transpose = _gather_check(torch, f"{tag}: transpose Xᵀr", r, batch.dim,
                              tail=(vals, rows, None, col_ptr), chunks=chunks)
    layout = "hybrid" if batch.has_hybrid_view else "ell" if batch.has_ell_view else "flat"
    return [dict(margins, layout=layout, chunk_rows=0 if batch.row_chunks is None
                 else int(batch.row_chunks.rows.numel())),
            dict(transpose, layout="column-sorted plan", chunk_rows=0 if chunks is None
                 else int(chunks.rows.numel()))]


class _FitCapture:
    """The dataset and result of every ``GameEstimator.fit`` while open (a
    driver's own training data, for the checks on its inputs), by wrapping
    the method (restored on exit)."""

    def __init__(self):
        self.fits: list = []

    def __enter__(self):
        from photon_ml_torch.estimators import GameEstimator

        self._fit = fit = GameEstimator.fit

        def recorded(est, dataset, *args, **kw):
            out = fit(est, dataset, *args, **kw)
            self.fits.append((dataset, out))
            return out

        GameEstimator.fit = recorded
        return self

    def __exit__(self, *exc):
        from photon_ml_torch.estimators import GameEstimator

        GameEstimator.fit = self._fit


def _driver_gather_checks(torch, tag: str, capture: _FitCapture, run: dict) -> None:
    """G1 on a driver's own training data, into ``run`` (its launch counts):
    ``checks``, :func:`_fe_gather_checks` on the last fit's batch of the
    ``global`` shard at its fixed effect's coefficients, and, where the
    model has a compact per-user effect, ``compact_check``
    (:func:`_compact_check` of its table on the training rows). A run that
    launched the chunk kernel must have had it checked."""
    from photon_ml_torch.models.game import compact_entries

    dataset, result = capture.fits[-1]
    w = result.model.get("fixed").glm.coefficients.means
    run["checks"] = _fe_gather_checks(torch, tag, dataset.fixed_effect_batch("global"), w)
    assert not run["chunks"] or any(c["chunk_rows"] for c in run["checks"]), run
    user = result.model.models.get("per_user")
    if user is not None:
        entries = compact_entries(
            dataset.feature_shards[user.feature_shard_id],
            dataset.host_array(f"entity_idx/{user.random_effect_type}"), user.active_cols,
            user.coefficients.device)
        run["compact_check"] = _compact_check(torch, f"{tag}: compact scores", entries,
                                              user.coefficients.float().contiguous())


def _small_compact_agreement(torch, np, seed: int, dev, card: str) -> None:
    """One per-user update (Newton lanes, from zero) of a small compact
    problem on the card in f32 against the CPU in f64: tables within
    1e-3 max|w|."""
    s = SPARSE_GAME["small"]
    part, _ = _sparse_game_arrays(np, seed + 1, s["n"], s["d"], SPARSE_GAME["per_row"],
                                  s["users"])
    tables = {}
    for where, dtype in ((dev, np.float32), (torch.device("cpu"), np.float64)):
        ds = _sparse_game_dataset(part, s["d"], where, dtype=dtype)
        _, coords = _sparse_game_estimator("NEWTON", 1)._build_coordinates(ds, None)
        coord = coords["per_user"]
        new, _ = coord.update_model(coord.initial_model(), None)
        tables[where.type] = new.coefficients.double().cpu()
        shape = list(new.coefficients.shape)
    gap = float((tables[dev.type] - tables["cpu"]).abs().max())
    scale = float(tables["cpu"].abs().max())
    _log(f"small compact problem n={s['n']} d={s['d']} users={s['users']} table {shape}: one "
         f"per-user Newton update, card f32 vs cpu f64 max |dw| {gap:.3g} (limit 1e-3 · max|w| "
         f"= {1e-3 * scale:.3g}) ({card})")
    assert gap <= 1e-3 * scale


def _sparse_game_slice(torch, np, seed: int, dev, card: str) -> tuple[dict, dict]:
    """Phase 9, the sparse GAME slice at bench.py:721's shapes (none cut): a
    fixed effect and a compact per-user random effect on one sparse shard,
    through ``GameEstimator.fit``. Returns (the path: for each kernel this
    path runs, its launches here and its checks on the path's own inputs,
    the fixed effect's margins and transposes over fits a's and b's batches
    and compact scoring over fit a's table; the kernels-line entry of
    compact scoring). The path's ``sparse_gather`` launches are the fixed
    effect's; compact scoring's row or segment launches stand apart."""
    import dataclasses

    from photon_ml_torch.data.game_data import build_random_effect_dataset
    from photon_ml_torch.data.sparse_batch import HybridPolicy
    from photon_ml_torch.models import game
    from photon_ml_torch.ops.normalization import NormalizationType, build_normalization

    cfg = SPARSE_GAME
    sweeps = cfg["sweeps"]
    t0 = time.perf_counter()
    train, held = _sparse_game_arrays(np, seed, cfg["n"], cfg["d"], cfg["per_row"],
                                      cfg["users"], cfg["held_out"])
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = _sparse_game_dataset(train, cfg["d"], dev)
    held_ds = _sparse_game_dataset(held, cfg["d"], dev, vocabs=ds.entity_vocabs)
    torch.cuda.synchronize()
    rows_per_user = np.bincount(ds.host_array("entity_idx/user"))
    shard = ds.feature_shards["global"]
    _log(f"sparse GAME data (bench.py:721, none cut) n={cfg['n']} (+{cfg['held_out']} held "
         f"out) d={cfg['d']}, {cfg['per_row']} Zipf columns a row ({shard.nnz} entries, "
         f"{len(shard.coalesced()[0])} after duplicates add up), {cfg['users']} users with "
         f"{rows_per_user.min()}-{rows_per_user.max()} rows (mean {rows_per_user.mean():.1f}): "
         f"numpy {t_arrays:.2f} s, build_game_dataset x2 {time.perf_counter() - t0:.2f} s")

    # the host builders: the compact buckets and the entries' table slots
    t0 = time.perf_counter()
    re_ds = build_random_effect_dataset(ds, "user", "global")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k = re_ds.table_width
    support = (re_ds.active_cols < cfg["d"]).sum(axis=1)
    fields = ("features", "labels", "weights", "entity_rows", "sample_rows", "col_index")
    bucket_bytes = sum(getattr(b, f).numel() * getattr(b, f).element_size()
                       for b in re_ds.buckets for f in fields)
    t0 = time.perf_counter()
    game.compact_entry_positions(shard, ds.host_array("entity_idx/user"), re_ds.active_cols)
    positions_s = time.perf_counter() - t0
    _log(f"compact per-user effect ({card}): K = {k} (active columns a user {support.min()}-"
         f"{support.max()}, mean {support.mean():.1f}), buckets "
         f"{[list(b.features.shape) for b in re_ds.buckets]}, {bucket_bytes} bytes (a dense "
         f"[{cfg['users']}, {cfg['d']}] f32 table alone would be "
         f"{4 * cfg['users'] * cfg['d']} bytes); host build: "
         f"_build_sparse_random_effect_dataset {build_s:.3f} s, compact_entry_positions "
         f"{positions_s:.3f} s")
    del re_ds

    # STANDARDIZATION has mean shifts, which would densify the shard: refused
    stats = shard.summarize(ds.host_array("weights"))
    stat = {key: torch.as_tensor(np.asarray(stats[key]), dtype=torch.float32, device=dev)
            for key in ("mean", "variance", "max_magnitude")}
    standard = build_normalization(NormalizationType.STANDARDIZATION, **stat, intercept_index=0)
    try:
        build_random_effect_dataset(ds, "user", "global", normalization=standard)
        raise AssertionError("STANDARDIZATION on a compact random effect was not refused")
    except ValueError as e:
        assert "SCALE-only" in str(e), e
    del stat, standard

    _sparse_game_estimator("NEWTON", 1).fit(ds)  # warm up outside the times
    hybrid = dataclasses.replace(shard, hybrid_policy=HybridPolicy(hot_cols=cfg["hot_cols"],
                                                                   label="sparse_game"))
    ds_hybrid = dataclasses.replace(ds, feature_shards={"global": hybrid}, _sparse_batches={})
    plan = {
        "a. ELL, compact L-BFGS lanes": (ds, "LBFGS", {}),
        "a. ELL, compact L-BFGS lanes, again": (ds, "LBFGS", {}),
        "b. hybrid 256-column head, compact Newton lanes": (ds_hybrid, "NEWTON", {}),
        "c. scaled, compact L-BFGS lanes, full variances": (
            ds, "LBFGS", dict(normalization="SCALE_WITH_MAX_MAGNITUDE",
                              compute_variance=True)),
    }
    fits = {}
    for label, (data, lanes, kw) in plan.items():
        reference = SCALED_FIT_REFERENCE.get(seed) if "normalization" in kw else None
        if "normalization" in kw and reference is None:
            _log(f"no JAX reference for the scaled fit at seed {seed}: its held-out RMSE is "
                 "printed, not held")
            reference = {}
        fits[label] = _sparse_game_fit(torch, label, _sparse_game_estimator(lanes, sweeps, **kw),
                                       data, held_ds, sweeps, reference)
        torch.cuda.empty_cache()

    # a. twice: bitwise equal tables and scores
    runs = [fits[label]["result"].model for label in list(plan)[:2]]
    for cid in ("fixed", "per_user"):
        m1, m2 = runs[0].get(cid), runs[1].get(cid)
        t1 = m1.glm.coefficients.means if cid == "fixed" else m1.coefficients
        t2 = m2.glm.coefficients.means if cid == "fixed" else m2.coefficients
        assert torch.equal(t1, t2), f"fit a's two runs differ in {cid}"
    assert torch.equal(runs[0].score(held_ds), runs[1].score(held_ds))
    # c. variances finite and positive on each user's support, NaN off it
    user = fits["c. scaled, compact L-BFGS lanes, full variances"]["result"].model.get("per_user")
    var = user.variances.double().cpu().numpy()
    on = user.active_cols < cfg["d"]
    assert np.isfinite(var[on]).all() and (var[on] > 0).all() and np.isnan(var[~on]).all()
    _log(f"sparse GAME checks ({card}): fit a's two runs bitwise equal (tables, coefficients, "
         f"held-out scores); variances on support {var[on].min():.4g}-{var[on].max():.4g}, NaN "
         f"off it; held-out RMSE " + json.dumps(
             {label: [f["held_out_rmse"], f["fe_alone_held_out_rmse"]]
              for label, f in fits.items()}) + " (GAME, fixed effect alone)")
    del user, var, runs

    _small_compact_agreement(torch, np, seed, dev, card)

    # one lane update's wall and device time, with kernels
    for lanes in ("LBFGS", "NEWTON"):
        share = _lane_loop_share(torch, _sparse_game_estimator(lanes, 1, evaluators=()), ds)
        _log(f"lane loop, one compact per-user update, {lanes} lanes ({card}): "
             + json.dumps(share))

    # compact scoring on this path's own inputs (fit a's table on the
    # training rows): through G1 against its plain version in f64
    model = fits["a. ELL, compact L-BFGS lanes"]["result"].model.get("per_user")
    table = model.coefficients.float().contiguous()
    entries = game.compact_entries(shard, ds.host_array("entity_idx/user"), model.active_cols,
                                   dev)
    check = _compact_check(torch, "compact scoring on the sparse GAME training rows", entries,
                           table)
    _reset_gather_counts()
    entry = _compact_entry(torch, "experiments/sparse_gather_probe.py:70", entries, table, check)
    _log(f"compact scoring through G1 [{entries.num_samples} rows, {entries.vals.numel()} "
         f"entries] table {list(table.shape)} ({card}): " + json.dumps(check) + " "
         + json.dumps(entry))
    # the fixed effect's gathers on this path's own inputs: fit a's ELL
    # batch and fit b's hybrid batch at their fitted coefficients
    fe_checks = []
    for label, data in (("a. ELL, compact L-BFGS lanes", ds),
                        ("b. hybrid 256-column head, compact Newton lanes", ds_hybrid)):
        w = fits[label]["result"].model.get("fixed").glm.coefficients.means
        fe_checks += _fe_gather_checks(torch, f"sparse GAME fit {label}",
                                       data.fixed_effect_batch("global"), w)
    _log(f"the fixed effect's gathers on the sparse GAME training batches ({card}): "
         + json.dumps(fe_checks))
    chunked = [c for c in fe_checks if c["chunk_rows"]]
    assert chunked, "the Zipf-hot columns should take the chunk kernel"
    launches = {key: sum(f["launches"][key] for f in fits.values())
                for key in ("rows", "segments", "chunks", "compact")}
    entry["launches"] = launches["compact"]
    # the row and segment counters include compact scoring's launches
    fe_launches = launches["rows"] + launches["segments"] - launches["compact"]
    path = {"sparse_gather": {"launches": fe_launches, "row_kernel": launches["rows"],
                              "segment_kernel": launches["segments"],
                              "compact_scoring": launches["compact"], "checks": fe_checks},
            "sparse_gather_chunks": {"launches": launches["chunks"], "checks": chunked},
            "sparse_gather_compact": dict(check, launches=launches["compact"])}
    for label, f in fits.items():
        _log(f"sparse GAME fit {label} ({card}): seconds a sweep {f['seconds_per_sweep']:.4f} "
             f"(fixed effect {f['fe_per_sweep']:.4f}, per-user {f['re_per_sweep']:.4f}, "
             f"rescoring {f['rescoring_per_sweep']:.4f}, host rest "
             f"{f['host_rest_per_sweep']:.4f}); launches {json.dumps(f['launches'])}")
    assert all(v["launches"] > 0 for v in path.values()), path
    del fits, ds, held_ds, ds_hybrid, model, table, entries
    torch.cuda.empty_cache()
    return path, entry


#: phase 8's sparse drivers: GAME on sparse Avro at phase 9's distribution
#: (name-term bag over d = 10^6 Zipf columns, 16 a row), rows cut to 8,192 +
#: 2,048 as the dense drivers' are (the pure-Python codec) and users to 250,
#: so a user keeps about phase 9's 33 rows; the GLM driver on LibSVM at
#: LIBSVM a1a's widths (123 binary features, 14 a row, 1,605 training rows;
#: validation as many); the GAME driver on LibSVM at phase 9's full width
#: and rows (pre-indexed, d = 10^6, 2^16 rows of 16 entries), fixed effect
#: only (LibSVM carries no id columns).
SPARSE_DRIVERS = dict(game_rows=8192, validation_rows=2048, users=250, d=1_000_000,
                      a1a_rows=1605, a1a_d=123, a1a_per_row=14, libsvm_rows=1 << 16)


def _write_libsvm(np, path, labels, rows, cols, vals, n: int) -> float:
    """LibSVM text of row-sorted entries, 1-based indices, one line a row;
    seconds."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    starts = [0, *np.cumsum(np.bincount(rows, minlength=n)).tolist()]
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{c + 1}:{v!r}" for c, v in
                             zip(cols[starts[i]:starts[i + 1]].tolist(),
                                 vals[starts[i]:starts[i + 1]].tolist()))
            f.write(f"{labels[i]!r} {feats}\n")
    return time.perf_counter() - t0


def _sparse_driver_slice(torch, np, seed: int, dev, tmp: Path, card: str) -> dict:
    """Phase 8's sparse drivers (``SPARSE_DRIVERS``): (i) the GAME training
    driver on sparse Avro with a compact per-user effect on the fixed
    effect's shard, its index maps from the port's feature indexing driver,
    then the scoring driver on its model (Avro scores bitwise the loaded
    model's in-process scores); (ii) the GLM driver on LibSVM (validation AUC
    above 0.6); (iii) the GAME training driver on pre-indexed LibSVM at full
    width. Returns each run's kernel launches (counters set to 0 before it)."""
    from photon_ml_torch.cli import (
        feature_indexing_driver,
        game_scoring_driver,
        game_training_driver,
        glm_driver,
    )
    from photon_ml_torch.io import photon_schemas
    from photon_ml_torch.io.data_reader import read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model, read_scores
    from photon_ml_torch.cli.configs import parse_feature_shard_config
    from photon_ml_torch.models.game import compact_entries
    from photon_ml_torch.ops import fused_glm

    cfg = SPARSE_DRIVERS
    launches = {}
    # (i) GAME on sparse Avro, a name-term bag
    n, nv = cfg["game_rows"], cfg["validation_rows"]
    train, held = _sparse_game_arrays(np, seed + 6, n, cfg["d"], SPARSE_GAME["per_row"],
                                      cfg["users"], nv)

    def record(part, offset):
        cols, vals = part["cols"].tolist(), part["vals"].tolist()
        y, users, per_row = part["labels"].tolist(), part["users"].tolist(), \
            SPARSE_GAME["per_row"]
        return lambda i: {
            "uid": str(offset + i), "label": y[i], "weight": 1.0, "offset": 0.0,
            "foldId": None, "metadataMap": {"userId": users[i]},
            "features": [{"name": "w", "term": str(c), "value": v} for c, v in
                         zip(cols[i * per_row:(i + 1) * per_row],
                             vals[i * per_row:(i + 1) * per_row])]}

    te = photon_schemas.TRAINING_EXAMPLE_AVRO
    write_s = _write_avro(tmp / "sparse/train/part-00000.avro", te, n, record(train, 0))
    _write_avro(tmp / "sparse/validation/part-00000.avro", te, nv, record(held, n))
    spec = "name=global,feature.bags=features,intercept=true,sparse=true"
    t0 = time.perf_counter()
    sizes = feature_indexing_driver.main([
        "--input-data-path", str(tmp / "sparse/train"), "--output-dir",
        str(tmp / "sparse/index-maps"), "--feature-shard-configurations", spec])
    index_s = time.perf_counter() - t0
    _reset_gather_counts()
    t0 = time.perf_counter()
    with _FitCapture() as capture:
        game = game_training_driver.main([
            "--input-data-path", str(tmp / "sparse/train"),
            "--validation-data-path", str(tmp / "sparse/validation"),
            "--root-output-dir", str(tmp / "sparse/out"), "--task-type", "LINEAR_REGRESSION",
            "--index-maps-dir", str(tmp / "sparse/index-maps"),
            "--feature-shard-configurations", spec,
            "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--coordinate-configurations",
            "name=per_user,feature.shard=global,reg.weights=1,max.iter=10,"
            "random.effect.type=userId",
            "--coordinate-descent-iterations", "2", "--evaluators", "RMSE"], device=dev)
        torch.cuda.synchronize()
    game_s = time.perf_counter() - t0
    launches["GAME training, sparse Avro"] = _gather_counts()
    # G1 on the driver's own training batch, after its launches were read
    _driver_gather_checks(torch, "GAME training driver, sparse Avro", capture,
                          launches["GAME training, sparse Avro"])
    del capture
    fe_alone = game["metric_history"][0]["metrics"][0]
    assert fe_alone["coordinate"] == "fixed" and game["best_metric"] < fe_alone["validate:RMSE"], \
        (game["best_metric"], fe_alone)
    run = launches["GAME training, sparse Avro"]
    assert run["compact"] > 0 and run["rows"] + run["segments"] > 0, run
    _reset_gather_counts()
    scored = game_scoring_driver.main([
        "--input-data-path", str(tmp / "sparse/validation"),
        "--model-input-dir", str(tmp / "sparse/out/best"),
        "--output-dir", str(tmp / "sparse/scored"), "--evaluators", "RMSE",
        "--feature-shard-configurations", spec, "--compact-random-effect-threshold", "0"],
        device=dev)
    torch.cuda.synchronize()
    launches["GAME scoring, sparse Avro"] = _gather_counts()
    assert launches["GAME scoring, sparse Avro"]["compact"] > 0
    avro_scores = np.asarray([r["predictionScore"]
                              for r in read_scores(tmp / "sparse/scored/scores")])
    maps = IndexMap.load_directory(tmp / "sparse/out/index-maps")
    model = load_game_model(tmp / "sparse/out/best", maps, compact_random_effect_threshold=0,
                            device=dev)
    assert model.get("per_user").is_compact
    ds = read_merged(tmp / "sparse/validation", dict([parse_feature_shard_config(spec)]),
                     index_maps=maps, random_effect_id_columns=("userId",),
                     entity_vocabs={"userId": model.get("per_user").entity_keys},
                     device=dev).dataset
    in_process = (model.score(ds) + ds.offsets).cpu().numpy()
    assert avro_scores.shape == (nv,) and np.array_equal(avro_scores,
                                                         in_process.astype(np.float64)), \
        float(np.abs(avro_scores - in_process).max())
    # G1 on the scoring run's own inputs: the loaded model's margins and
    # compact scores over the validation rows
    user = model.get("per_user")
    table = user.coefficients
    scoring = launches["GAME scoring, sparse Avro"]
    batch = ds.fixed_effect_batch("global")
    scoring["checks"] = [dict(_gather_check(
        torch, "GAME scoring driver, sparse Avro: margins X w",
        model.get("fixed").glm.coefficients.means.float().contiguous(), nv,
        **_batch_gather_args(batch)), chunk_rows=0 if batch.row_chunks is None
        else int(batch.row_chunks.rows.numel()))]
    scoring["compact_check"] = _compact_check(
        torch, "GAME scoring driver, sparse Avro: compact scores", compact_entries(
            ds.feature_shards["global"], ds.host_array(f"entity_idx/{user.random_effect_type}"),
            user.active_cols, dev), table.float().contiguous())
    _log(f"GAME drivers on sparse Avro ({card}): {n} + {nv} rows of a name-term bag (written "
         f"at {n / write_s:.0f} records/s), feature indexing driver {index_s:.2f} s ({sizes}), "
         f"training {game_s:.2f} s, validation RMSE {game['best_metric']:.6f} against the fixed "
         f"effect alone {fe_alone['validate:RMSE']:.6f}, compact per-user table "
         f"{list(table.shape)}; scoring driver RMSE {scored['evaluations']['RMSE']:.6f}, its "
         f"{nv} Avro scores bitwise equal to the loaded model's in-process scores; launches "
         + json.dumps(launches) + "; stages "
         + json.dumps({k: round(v["total"], 4) for k, v in game["timings"].items()}))
    del model, ds, table, user, batch

    # (ii) the GLM driver on LibSVM at a1a's widths
    rng = np.random.default_rng(seed + 8)
    na, da, pa = cfg["a1a_rows"], cfg["a1a_d"], cfg["a1a_per_row"]
    w_true = rng.normal(size=da)
    for name in ("train", "validation"):
        cols = np.sort(np.argsort(rng.random((na, da)), axis=1)[:, :pa], axis=1)
        margin = w_true[cols].sum(axis=1) / np.sqrt(pa)
        y = np.where(rng.uniform(size=na) < 1.0 / (1.0 + np.exp(-margin)), 1, -1)
        _write_libsvm(np, tmp / f"a1a/{name}.txt", y.tolist(), np.repeat(np.arange(na), pa),
                      cols.ravel(), np.ones(na * pa), na)
    fused_glm.launches = fused_glm.reduce_launches = 0
    t0 = time.perf_counter()
    glm = glm_driver.main([
        "--input-data-path", str(tmp / "a1a/train.txt"),
        "--validation-data-path", str(tmp / "a1a/validation.txt"),
        "--output-dir", str(tmp / "a1a/out"), "--task-type", "LOGISTIC_REGRESSION",
        "--regularization-weights", "1,10", "--input-format", "libsvm"],
        device=dev)
    torch.cuda.synchronize()
    glm_s = time.perf_counter() - t0
    launches["GLM, LibSVM"] = {"fused_glm": fused_glm.launches,
                               "fused_glm_reduce": fused_glm.reduce_launches}
    aucs = {lam: m["AUC"] for lam, m in glm.validation_metrics.items()}
    assert launches["GLM, LibSVM"]["fused_glm"] > 0 and glm.stage.name == "VALIDATED"
    assert aucs[glm.best_lambda] > 0.6, aucs
    _log(f"GLM driver on LibSVM at a1a's widths ({na} + {na} rows, {da} features, {pa} a row) "
         f"({card}): {glm_s:.2f} s, validation AUC {json.dumps(aucs)}, best λ "
         f"{glm.best_lambda}, launches {json.dumps(launches['GLM, LibSVM'])}")

    # (iii) the GAME driver on pre-indexed LibSVM at full width
    nl = cfg["libsvm_rows"]
    part, _ = _sparse_game_arrays(np, seed + 7, nl, cfg["d"], SPARSE_GAME["per_row"],
                                  SPARSE_GAME["users"])
    text_s = _write_libsvm(np, tmp / "libsvm/train.txt", part["labels"].tolist(), part["rows"],
                           part["cols"], part["vals"], nl)
    _reset_gather_counts()
    t0 = time.perf_counter()
    with _FitCapture() as capture:
        pre = game_training_driver.main([
            "--input-data-path", str(tmp / "libsvm/train.txt"), "--input-format", "libsvm",
            "--root-output-dir", str(tmp / "libsvm/out"), "--task-type", "LINEAR_REGRESSION",
            "--feature-shard-configurations",
            f"name=global,feature.bags=features,intercept=false,pre.indexed=true,"
            f"dimension={cfg['d']},sparse=true",
            "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--model-output-mode", "BEST"], device=dev)
        torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    launches["GAME training, pre-indexed LibSVM"] = _gather_counts()
    run = launches["GAME training, pre-indexed LibSVM"]
    assert run["rows"] + run["segments"] > 0, run
    _driver_gather_checks(torch, "GAME training driver, pre-indexed LibSVM", capture, run)
    del capture
    parse_s = pre["timings"]["libsvm parse"]["total"]
    loss = [h["metrics"] for h in pre["metric_history"]][0]
    _log(f"GAME driver on pre-indexed LibSVM, d={cfg['d']}, {nl} rows of "
         f"{SPARSE_GAME['per_row']} entries ({card}): {pre_s:.2f} s; LibSVM text written in "
         f"{text_s:.2f} s, parsed at {nl / parse_s:.0f} records/s ({parse_s:.2f} s); training "
         f"loss {json.dumps(loss)}; launches {json.dumps(run)}; stages "
         + json.dumps({k: round(v["total"], 4) for k, v in pre["timings"].items()}))
    return launches


#: phase 10, matrix factorization (ROADMAP item 13): (a) bench.py's flagship
#: GAME widths (bench.py:542-560) with a user × item MF coordinate (k = 16,
#: 2 alternations) beside the fixed effect and the per-user effect, linear
#: labels carrying a planted rank-16 user·item term; (b) MovieLens-1M's
#: published widths (GroupLens ml-1m: 6,040 users, 3,706 movies, 1,000,209
#: ratings, at least 20 a user), none cut: the ``global`` shard is the
#: one-hot of its own attributes (intercept, gender 2, age 7, occupation 21,
#: genres 18: d = 49), k = 32; (c) a small problem on the card against the CPU.
MF = {
    "flagship": dict(GAME["flagship"], k=16, alternations=2),
    "movielens": dict(users=6040, movies=3706, ratings=1_000_209, min_count=20,
                      max_count=2314, held_out=1 << 16, k=32, sweeps=4, genders=2, ages=7,
                      occupations=21, genres=18),
    "small": dict(GAME["small"], k=4),
}


def _planted_mf(np, seed: int, part, users: int, items: int, k: int, scale: float = 0.5):
    """``part``'s linear labels plus a planted rank-k term u_user · v_item
    (u, v ~ N(0, scale²), so the term's variance is k·scale⁴); the user rows
    cover the held-out users never trained on too."""
    rng = np.random.default_rng(seed)
    u = (scale * rng.normal(size=(2 * users, k))).astype(np.float32)
    v = (scale * rng.normal(size=(items, k))).astype(np.float32)
    ui = np.char.lstrip(part["keys"]["user"], "u").astype(np.int64)
    ii = np.char.lstrip(part["keys"]["item"], "i").astype(np.int64)
    part["labels"]["LINEAR_REGRESSION"] = part["labels"]["LINEAR_REGRESSION"] + np.einsum(
        "nk,nk->n", u[ui], v[ii]).astype(np.float32)
    return part


def _mf_estimator(sweeps: int, *, k: int, mf_lanes: str = "AUTO", mf: bool = True,
                  per_user: bool = True, alternations: int = 2, mf_l2: float = 10.0, **kw):
    """The flagship configuration of ``_game_estimator`` with the per-user
    effect only, plus (``mf``) a user × item MF coordinate with ``mf_lanes``
    (AUTO resolves to Newton lanes), 10 iterations, L2 weight ``mf_l2``: at
    weight 1 the factors of an entity's 66-87 rows fit its noise (held-out
    RMSE above the fit without MF, by a CPU rehearsal at a sixteenth of the
    rows); at 30 they shrink to the zero saddle."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import MatrixFactorizationCoordinateConfig

    est = _game_estimator("LINEAR_REGRESSION", "NEWTON", sweeps, **kw)
    configs = {c: v for c, v in est.coordinate_configs.items()
               if c == "fixed" or (per_user and c == "per_user")}
    if mf:
        from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType

        configs["mf"] = MatrixFactorizationCoordinateConfig(
            "user", "item", num_latent_factors=k, num_alternations=alternations,
            optimization=CoordinateOptimizationConfig(
                optimizer=OptimizerConfig(OptimizerType[mf_lanes], max_iterations=10),
                l2_weight=mf_l2))
    est.coordinate_configs = configs
    return est


def _rmse(torch, np, model, dataset) -> float:
    scores = (model.score(dataset) + dataset.offsets).double().cpu().numpy()
    assert np.isfinite(scores).all()
    return float(np.sqrt(np.mean((scores - dataset.host_array("labels")) ** 2)))


def _mf_buckets(mf_dataset, k: int) -> dict:
    """Each side's bucket shapes and bytes (labels, weights, entity and
    sample rows), and the bytes of the [e, cap, k] f32 features one solve
    gathers."""
    out = {}
    for side in ("row", "col"):
        buckets = getattr(mf_dataset, f"{side}_buckets")
        out[side] = {
            "shapes": [[b.num_entities, int(b.labels.shape[1])] for b in buckets],
            "bytes": sum(getattr(b, f).numel() * getattr(b, f).element_size() for b in buckets
                         for f in ("labels", "weights", "entity_rows", "sample_rows")),
            "feature_bytes_per_solve": [b.num_entities * int(b.labels.shape[1]) * k * 4
                                        for b in buckets]}
    return out


def _mf_half_step(coord, model):
    """A callable running one MF half-step of ``coord`` from ``model``: every
    row bucket's lane solve against the fixed column factors."""
    from photon_ml_torch.algorithm.coordinates import _solve_config
    from photon_ml_torch.algorithm.mf_coordinate import solve_mf_side_bucket
    from photon_ml_torch.ops.losses import loss_for_task
    from photon_ml_torch.ops.objective import GLMObjective

    objective = GLMObjective(loss_for_task(coord.task), l2_weight=coord.config.l2_weight,
                             use_kernel=False)
    opt = _solve_config(coord.config, loss=objective.loss, small_dense=True)
    col_idx = coord.dataset.entity_idx[coord.mf_dataset.col_effect_type]

    def run():
        rows = model.row_factors
        for b in coord.mf_dataset.row_buckets:
            rows, _ = solve_mf_side_bucket(objective, opt, b.labels, b.weights, b.entity_rows,
                                           b.sample_rows, col_idx, model.col_factors,
                                           coord.dataset.offsets, rows)
        return rows

    return run


def _movielens_arrays(np, seed: int, users: int, movies: int, ratings: int, min_count: int,
                      max_count: int, held_out: int, k: int, genders: int, ages: int,
                      occupations: int, genres: int, **_):
    """Ratings at MovieLens-1M's published widths from ``seed``: per-user
    counts Zipf-like from ``min_count`` to ``max_count`` summing to
    ``ratings``, each user's movies drawn without replacement by a Zipf
    popularity; user attributes (gender, age, occupation) and 1-3 genres a
    movie one-hot in the ``global`` shard with an intercept; ratings 1-5
    from a planted model (attribute effects plus a rank-k user·movie term)
    plus noise, rounded and clipped. ``held_out`` more ratings of the same
    model follow (users and movies all seen)."""
    rng = np.random.default_rng(seed)
    rank = np.arange(1, users + 1, dtype=np.float64)
    lo, hi = 1e-3, 3.0  # the Zipf exponent whose counts sum to ``ratings``

    def counts_for(s):  # min_count at the last rank, max_count at the first
        tail = users ** -s
        return min_count + np.floor((max_count - min_count) * (rank ** -s - tail)
                                    / (1.0 - tail) + 1e-9).astype(np.int64)

    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if counts_for(mid).sum() > ratings else (lo, mid)
    counts = counts_for(hi)
    short = ratings - int(counts.sum())
    counts[np.argsort(counts)[:short]] += 1  # the smallest users take the rest
    assert counts.sum() == ratings and counts.min() >= min_count and counts.max() == max_count
    counts = rng.permutation(counts)
    pop = 1.0 / np.arange(1, movies + 1) ** 0.9
    pop /= pop.sum()
    movie_perm = rng.permutation(movies)
    total = ratings + held_out
    extra = rng.integers(0, users, size=held_out)
    per_user = counts + np.bincount(extra, minlength=users)
    user_idx = np.repeat(np.arange(users), per_user)
    movie_idx = np.concatenate([movie_perm[rng.choice(movies, size=c, replace=False, p=pop)]
                                for c in per_user])
    gender = rng.integers(0, genders, size=users)
    age = rng.integers(0, ages, size=users)
    occupation = rng.integers(0, occupations, size=users)
    movie_genres = np.zeros((movies, genres), dtype=np.float32)
    for m in range(movies):
        movie_genres[m, rng.choice(genres, size=rng.integers(1, 4), replace=False)] = 1.0
    d = 1 + genders + ages + occupations + genres
    x = np.zeros((total, d), dtype=np.float32)
    x[:, 0] = 1.0
    rows = np.arange(total)
    x[rows, 1 + gender[user_idx]] = 1.0
    x[rows, 1 + genders + age[user_idx]] = 1.0
    x[rows, 1 + genders + ages + occupation[user_idx]] = 1.0
    x[:, 1 + genders + ages + occupations:] = movie_genres[movie_idx]
    w = np.concatenate([[3.58], 0.3 * rng.normal(size=d - 1)])
    u = 0.45 * rng.normal(size=(users, k))
    v = 0.45 * rng.normal(size=(movies, k))
    z = x @ w + np.einsum("nk,nk->n", u[user_idx], v[movie_idx]) \
        + 0.5 * rng.normal(size=total)
    y = np.clip(np.rint(z), 1, 5).astype(np.float32)
    order = rng.permutation(total)
    held = order[:held_out]
    train = np.sort(order[held_out:])
    keys = {"user": np.char.add("u", user_idx.astype(str)),
            "item": np.char.add("m", movie_idx.astype(str))}

    def part(sel):
        return dict(x=x[sel], labels=y[sel], keys={t: v_[sel] for t, v_ in keys.items()})

    return part(train), part(held), counts


def _mf_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 10: matrix factorization through ``GameEstimator.fit`` (``MF``),
    printing as it goes. Returns, for each kernel this path runs, its
    launches here and its check on the path's own fixed-effect inputs."""
    from dev import torch_kernel_probe
    from photon_ml_torch import convert
    from photon_ml_torch.algorithm import mf_coordinate
    from photon_ml_torch.data.game_data import build_game_dataset
    from photon_ml_torch.models.game import GameModel
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import SquaredLoss

    # a. the flagship widths with a planted rank-16 user·item term
    shape = MF["flagship"]
    sweeps, k = shape["sweeps"], shape["k"]
    t0 = time.perf_counter()
    train, held = _game_arrays(np, seed + 7, **shape)
    train = _planted_mf(np, seed + 8, train, shape["users"], shape["items"], k)
    held = _planted_mf(np, seed + 8, held, shape["users"], shape["items"], k)
    lin = "LINEAR_REGRESSION"
    ds = _game_dataset(train, lin, dev)
    held_ds = _game_dataset(held, lin, dev, vocabs=ds.entity_vocabs)
    torch.cuda.synchronize()
    unseen = (held_ds.entity_idx["user"] < 0).cpu().numpy()
    assert unseen.any()
    _log(f"MF GAME data n={shape['n']} (+{shape['held_out']} held out, {int(unseen.sum())} of "
         f"unseen users) global d={shape['d_fe']} per_entity d={shape['d_re']} "
         f"users={shape['users']} items={shape['items']}, linear labels plus a planted rank-{k} "
         f"user·item term: {time.perf_counter() - t0:.2f} s")
    del train, held
    alt = shape["alternations"]
    # warm up outside the times
    _mf_estimator(1, k=k, alternations=alt).fit(ds)
    fits = {}
    for label, kw in (("a. fixed + per-user + mf, newton mf lanes", {}),
                      ("a. the same fit again", {}),
                      ("a. mf with l-bfgs lanes", {"mf_lanes": "LBFGS"}),
                      ("a. fixed + per-user, no mf, mma", {"mf": False, "kernel_unit": "mma"})):
        fits[label] = _game_fit(torch, label, _mf_estimator(sweeps, k=k, alternations=alt, **kw),
                                ds, sweeps)
        torch.cuda.empty_cache()
    main_fit = fits["a. fixed + per-user + mf, newton mf lanes"]
    model = main_fit["result"].model
    again = fits["a. the same fit again"]["result"].model
    plain_model, plain_again = (convert.game_model_to_numpy(m) for m in (model, again))
    bitwise = all(np.array_equal(v, plain_again[c][f], equal_nan=True)
                  for c, m in plain_model.items() for f, v in m.items()
                  if isinstance(v, np.ndarray))
    gap = _rel_gap(fits["a. mf with l-bfgs lanes"]["loss_per_sweep"][-1],
                   main_fit["loss_per_sweep"][-1])
    rmse = {label: _rmse(torch, np, f["result"].model, held_ds) for label, f in fits.items()}
    mf_held = model.get("mf").score_dataset(held_ds).cpu().numpy()
    _log(f"a. MF flagship ({card}): held-out RMSE {json.dumps(rmse)}; L-BFGS against Newton MF "
         f"lanes final training loss rel gap {gap:.3g} (limit 1e-3); the Newton fit twice "
         f"bitwise equal: {bitwise}; MF scores of the {int(unseen.sum())} unseen users all 0: "
         f"{bool((mf_held[unseen] == 0).all())}")
    for label, f in fits.items():
        _log(f"MF fit {label} ({card}): seconds per sweep {f['seconds_per_sweep']:.4f}, by "
             f"coordinate {json.dumps(f['per_sweep'])}, rescoring "
             f"{f['rescoring_per_sweep']:.4f}, host rest {f['host_rest_per_sweep']:.4f}, bucket "
             f"builders {f['bucket_builder_seconds']:.3f} s; lane iterations "
             f"{json.dumps(f['lane_iteration_histogram'])}")
    assert bitwise, "the Newton MF fit did not repeat bitwise"
    assert gap <= 1e-3, f"L-BFGS MF lanes off Newton's by {gap}"
    assert bool((mf_held[unseen] == 0).all()), "an unseen user's MF score is not 0"
    no_mf = rmse["a. fixed + per-user, no mf, mma"]
    assert all(v < no_mf for label, v in rmse.items() if "no mf" not in label), rmse

    # the kernels on this path's own fixed-effect inputs (the main fit's model)
    x = ds.feature_shards["global"]
    w = model.get("fixed").glm.coefficients.means.float().contiguous()
    o = (ds.offsets + model.score(ds) - x @ w).contiguous()
    aux = packed_glm.pack_aux(ds.labels, o, ds.weights)
    loss = SquaredLoss()
    n = x.shape[0]
    r = torch.rand(n, device=dev)
    library = lambda: (torch.matmul(x, w), torch.matmul(r, x))  # noqa: E731
    nbytes = n * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8
    limits = torch_kernel_probe.limits("float32")
    tf32 = torch_kernel_probe.tf32_slack(loss, x, ds.labels, o, ds.weights, w, None, "mma", "mma")
    launches = {c: sum(f["launches"][c] for f in fits.values())
                for c in ("packed_launches", "mma_launches", "reduce_launches")}
    path = {
        "packed_glm": dict(_path_check(
            torch, "packed_glm on the MF slice's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
            library, limits, nbytes, x.shape),
            launches=launches["packed_launches"] - launches["mma_launches"]),
        "packed_glm[mma]": dict(_path_check(
            torch, "packed_glm[mma] on the MF slice's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False, margin_unit="mma",
                                           grad_unit="mma"),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False,
                                                     margin_unit="mma", grad_unit="mma"),
            library, limits, nbytes, x.shape, tf32), launches=launches["mma_launches"]),
    }
    fe_args = (loss, x, aux, None, None, None, w, None, False, "fma", "fma")
    path["packed_glm_reduce"] = dict(
        _reduce_entry(torch, "packed_glm_reduce on the MF slice's fixed effect",
                      lambda: packed_glm.launch_partials(*fe_args), packed_glm.reduce_partials,
                      packed_glm.reduce_partials_reference),
        launches=launches["reduce_launches"])
    assert all(v["launches"] > 0 for v in path.values()), {c: v["launches"]
                                                           for c, v in path.items()}
    _log(f"kernels on the MF slice's fixed effect {list(x.shape)} ({card}): "
         + json.dumps(path))
    del fits, main_fit, model, again, ds, held_ds, x, aux, o, r, fe_args
    torch.cuda.empty_cache()

    # b. MovieLens-1M's widths, nothing cut
    ml = MF["movielens"]
    t0 = time.perf_counter()
    train, held, counts = _movielens_arrays(np, seed + 9, **ml)
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    mds = build_game_dataset(labels=train["labels"], feature_shards={"global": train["x"]},
                             entity_keys=train["keys"], device=dev)
    mheld = build_game_dataset(labels=held["labels"], feature_shards={"global": held["x"]},
                               entity_keys=held["keys"], entity_vocabs=mds.entity_vocabs,
                               device=dev)
    torch.cuda.synchronize()
    _log(f"b. MovieLens-1M widths: {mds.num_samples} ratings (+{mheld.num_samples} held out) of "
         f"{len(mds.entity_vocabs['user'])} users ({counts.min()}-{counts.max()} ratings each) "
         f"and {len(mds.entity_vocabs['item'])} movies, global d={train['x'].shape[1]}, "
         f"ratings 1-5 (mean {train['labels'].mean():.3f}): numpy {t_arrays:.2f} s, "
         f"build_game_dataset x2 {time.perf_counter() - t0:.2f} s")
    del train, held
    t0 = time.perf_counter()
    built = mf_coordinate.build_mf_dataset(mds, "user", "item")
    torch.cuda.synchronize()
    builder_s = time.perf_counter() - t0
    buckets = _mf_buckets(built, ml["k"])
    _log(f"MovieLens MF buckets ({card}): host builder {builder_s:.3f} s; " + json.dumps(buckets))
    del built
    kw = dict(k=ml["k"], per_user=False, alternations=2)
    _mf_estimator(1, **kw).fit(mds)  # warm up
    ml_fits = {"b. movielens fixed + mf k=32": _game_fit(
        torch, "b. movielens fixed + mf k=32", _mf_estimator(ml["sweeps"], **kw), mds,
        ml["sweeps"])}
    torch.cuda.empty_cache()
    ml_fits["b. movielens fixed effect only"] = _game_fit(
        torch, "b. movielens fixed effect only", _mf_estimator(1, mf=False, **kw), mds, 1)
    ml_rmse = {label: _rmse(torch, np, f["result"].model, mheld) for label, f in ml_fits.items()}
    ml_main = ml_fits["b. movielens fixed + mf k=32"]
    _log(f"b. MovieLens MF ({card}): seconds per sweep {ml_main['seconds_per_sweep']:.4f}, by "
         f"coordinate {json.dumps(ml_main['per_sweep'])}, rescoring "
         f"{ml_main['rescoring_per_sweep']:.4f}, host rest {ml_main['host_rest_per_sweep']:.4f}, "
         f"bucket builders {ml_main['bucket_builder_seconds']:.3f} s; held-out RMSE "
         + json.dumps(ml_rmse))
    assert ml_rmse["b. movielens fixed + mf k=32"] < ml_rmse["b. movielens fixed effect only"], \
        ml_rmse
    _, coords = _mf_estimator(1, **kw)._build_coordinates(mds, None)
    coord = coords["mf"]
    half = _profiled(torch, _mf_half_step(coord, ml_main["result"].model.get("mf")))
    _log(f"MovieLens MF half-step, the {len(coord.mf_dataset.row_buckets)} user buckets' Newton "
         f"lanes at k={ml['k']} ({card}): " + json.dumps(half))
    for label, f in ml_fits.items():
        path["packed_glm"].setdefault("movielens_launches", 0)
        path["packed_glm"]["movielens_launches"] += f["launches"]["packed_launches"]
        path["packed_glm_reduce"].setdefault("movielens_launches", 0)
        path["packed_glm_reduce"]["movielens_launches"] += f["launches"]["reduce_launches"]
    del ml_fits, ml_main, mds, mheld, coord, coords
    torch.cuda.empty_cache()

    # c. a small problem: one MF update from the same factors, card f32
    # against CPU f64
    small = MF["small"]
    arrays, _ = _game_arrays(np, seed + 10, **small)
    arrays = _planted_mf(np, seed + 11, arrays, small["users"], small["items"], small["k"])
    got, start = {}, None
    for where, dtype in ((dev, None), ("cpu", np.float64)):
        sds = _game_dataset(arrays, lin, where, dtype=dtype)
        _, coords = _mf_estimator(1, k=small["k"], per_user=False)._build_coordinates(sds, None)
        coord = coords["mf"]
        init = coord.initial_model()
        if start is None:
            start = convert.game_model_to_numpy(GameModel(models={"mf": init}))["mf"]
        carried = convert.game_model_from_numpy({"mf": dict(start)}, device=where).get("mf")
        carried = carried.with_factors(carried.row_factors.to(init.row_factors.dtype),
                                       carried.col_factors.to(init.col_factors.dtype))
        new, _ = coord.update_model(carried)
        got[str(where)] = torch.cat([new.row_factors.double().cpu().reshape(-1),
                                     new.col_factors.double().cpu().reshape(-1)])
    gap = float((got[str(dev)] - got["cpu"]).abs().max())
    scale = float(got["cpu"].abs().max())
    _log(f"c. small MF problem n={small['n']} k={small['k']}: one update, card f32 vs cpu f64 "
         f"max |d factor| {gap:.3g} (max |factor| {scale:.3g}, limit 1e-3·max)")
    assert gap <= 1e-3 * scale
    return path


#: phase 11, the fused GAME training program: bench.py's flagship widths
#: with phase 10's MF coordinate, phase 9's sparse shapes, and a small
#: problem for the card against the CPU
FUSED = {"flagship": dict(GAME["flagship"], k=16, alternations=2, mf_l2=10.0),
         "sparse": dict(SPARSE_GAME, dense_d=16, zero_share=0.5),
         "small": dict(GAME["small"], k=4)}


def _fused_program(*, k: int | None, alternations: int = 2, mf_l2: float = 10.0,
                   re_types=("user", "item"), fe_shard: str = "global", re_shard: str = "per_entity",
                   projector: str = "IDENTITY", task: str = "LOGISTIC_REGRESSION", mesh=None,
                   fe_feature_sharded: bool = False):
    """The fused program of ``_game_estimator`` plus phase 10's MF
    coordinate: the fixed effect on L-BFGS (10 iterations, L2 1), AUTO
    lanes (Newton; 10 iterations, L2 1) on each random effect, and with ``k``
    a user × item MF coordinate (AUTO lanes, L2 ``mf_l2``); with
    ``fe_feature_sharded`` the fixed effect over the mesh's model axis."""
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.projector.projectors import ProjectorType
    from photon_ml_torch.types import TaskType

    lbfgs = OptimizerConfig(OptimizerType.LBFGS, max_iterations=10)
    auto = OptimizerConfig(OptimizerType.AUTO, max_iterations=10)
    mfs = () if k is None else (dist.MatrixFactorizationStepSpec(
        "mf", "user", "item", k, auto, l2_weight=mf_l2, num_alternations=alternations),)
    return dist.GameTrainProgram(
        TaskType[task], dist.FixedEffectStepSpec(fe_shard, lbfgs, l2_weight=1.0),
        tuple(dist.RandomEffectStepSpec(t, re_shard, auto, l2_weight=1.0,
                                        projector=ProjectorType[projector]) for t in re_types),
        mf_specs=mfs, mesh=mesh, fe_feature_sharded=fe_feature_sharded)


def _fused_objective(torch, program, data, state) -> float:
    """The objective the fused sweep's block coordinate descent lowers, in
    f64: the weighted loss of the whole model plus each coordinate's L2
    penalty on its coefficients (the state's space; these programs carry no
    normalization). Each solve lowers its own block's part from its warm
    start, so the sum does not rise over the sweeps."""
    margins = program.score(data, state).double()
    total = torch.sum(data["weights"].double()
                      * program._loss.loss(margins, data["labels"].double()))
    if "mesh" in data:  # a rank's rows: the sum over the data axis
        total = data["mesh"].total(total.reshape(1))[0]
    total = float(total)

    def sq(t):
        return float((t.double() ** 2).sum())

    total += 0.5 * program.fe.l2_weight * sq(state.fe_coefficients)
    total += sum(0.5 * s.l2_weight * sq(state.re_tables[s.re_type]) for s in program.re_specs)
    total += sum(0.5 * m.l2_weight * (sq(state.mf_rows[m.name]) + sq(state.mf_cols[m.name]))
                 for m in program.mf_specs)
    return total


def _fused_run(torch, label: str, program, dataset, re_datasets, mf_datasets, sweeps: int,
               state=None, loss_falls: bool = True, mesh=None) -> dict:
    """``train_distributed`` with the launch counters set to 0 just before
    and read just after; per sweep its seconds, training loss, objective
    (:func:`_fused_objective`, computed after the run), the fixed effect's
    evaluations and B1's launches, and over a ``mesh`` the collectives and
    their bytes. The objective must not rise, nor, with ``loss_falls``, the
    training loss."""
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import mesh as mesh_ops

    evaluations = []
    objective = program._mesh_objectives["dense"] if mesh is not None else program._fe_objective
    inner = objective.value_and_gradient

    def counted(*args, **kw):
        evaluations.append(1)
        return inner(*args, **kw)

    objective.value_and_gradient = counted
    stepped = []
    step = program.step

    def recorded(data, buckets, state_):
        out = step(data, buckets, state_)
        stepped.append((data, out[0]))
        return out

    program.step = recorded
    marks = []

    def on_sweep(done, total, loss):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), len(evaluations), fused_glm.launches, loss,
                      mesh_ops.counts.snapshot()))

    fused_glm.launches = fused_glm.reduce_launches = 0
    _reset_gather_counts()
    mesh_ops.counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = dist.train_distributed(program, dataset, re_datasets, mf_datasets=mf_datasets,
                                        num_iterations=sweeps, state=state, on_sweep=on_sweep,
                                        mesh=mesh)
    finally:
        del objective.value_and_gradient, program.step
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    collectives = mesh_ops.counts.snapshot()
    launches = {"fused_glm": fused_glm.launches, "fused_glm_reduce": fused_glm.reduce_launches,
                **_gather_counts()}
    losses = result.losses
    objectives = [_fused_objective(torch, program, data, s) for data, s in stepped]
    stepped.clear()
    assert len(losses) == sweeps and all(math.isfinite(v) for v in losses), f"{label}: {losses}"
    assert all(b <= a * (1 + 1e-5) for a, b in zip(objectives, objectives[1:])), \
        f"{label}: the objective rose over the sweeps: {objectives}"
    assert not loss_falls or all(b <= a * (1 + 1e-5) for a, b in zip(losses, losses[1:])), \
        f"{label}: training loss rose over the sweeps: {losses}"
    rows, last = [], (t0, 0, 0, {})
    for (t, ev, b1, loss, coll), obj in zip(marks, objectives):
        row = {"seconds": t - last[0], "fe_evaluations": ev - last[1],
               "b1_launches": b1 - last[2], "loss": loss, "objective": obj}
        if mesh is not None:
            row["collectives"] = {
                op: {k: v[k] - last[3].get(op, {}).get(k, 0) for k in ("calls", "bytes")}
                for op, v in coll.items()}
        rows.append(row)
        last = (t, ev, b1, coll)
    out = {"run": label, "seconds": seconds, "seconds_per_sweep": seconds / sweeps,
           "sweeps": rows, "losses": losses, "launches": launches,
           "fe_evaluations": len(evaluations)}
    if mesh is not None:
        out["collectives"] = collectives
    _log(f"fused run {json.dumps(out)}")
    out["result"] = result
    return out


def _fused_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 11, the fused GAME training program (``parallel/distributed``),
    printing as it goes. Returns, for each kernel this path runs, its
    launches here and its checks on the path's own inputs."""
    from photon_ml_torch import convert
    from photon_ml_torch.algorithm.mf_coordinate import build_mf_dataset
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.data.game_data import build_game_dataset, build_random_effect_dataset
    from photon_ml_torch.data.sparse_batch import SparseShard
    from photon_ml_torch.estimators import MatrixFactorizationCoordinateConfig
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.io.index_map import IndexMap, feature_key
    from photon_ml_torch.io.model_io import load_game_model, save_game_model
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.projector.projectors import ProjectorType

    # a. the dense flagship: fixed effect, per-user and per-item effects and
    # a user × item MF coordinate, widths of bench.py:542-560 none cut
    shape = FUSED["flagship"]
    sweeps, k = shape["sweeps"], shape["k"]
    t0 = time.perf_counter()
    train, held = _game_arrays(np, seed + 20, **shape)
    task = "LOGISTIC_REGRESSION"
    ds = _game_dataset(train, task, dev)
    held_ds = _game_dataset(held, task, dev, vocabs=ds.entity_vocabs)
    del train, held
    re_ds = {t: build_random_effect_dataset(ds, t, "per_entity", bucket_sizes=(GAME["cap"],))
             for t in ("user", "item")}
    mf_ds = {"mf": build_mf_dataset(ds, "user", "item")}
    torch.cuda.synchronize()
    _log(f"a. fused flagship data n={shape['n']} (+{shape['held_out']} held out) global "
         f"d={shape['d_fe']} per_entity d={shape['d_re']} users={shape['users']} "
         f"items={shape['items']}, logistic; the buckets and MF buckets built: "
         f"{time.perf_counter() - t0:.2f} s")
    program = _fused_program(k=k, alternations=shape["alternations"], mf_l2=shape["mf_l2"])
    assert [s.optimizer.optimizer_type.name for s in (*program.re_specs, *program.mf_specs)] \
        == ["NEWTON"] * 3, "AUTO lanes did not resolve to Newton"
    _fused_run(torch, "a. warm-up", program, ds, re_ds, mf_ds, 1)
    main = _fused_run(torch, "a. fused flagship", program, ds, re_ds, mf_ds, sweeps)
    state = main["result"].state
    per_sweep = main["sweeps"]
    assert all(r["b1_launches"] == r["fe_evaluations"] > 0 for r in per_sweep), per_sweep
    assert main["launches"]["fused_glm_reduce"] == main["launches"]["fused_glm"]

    # one sweep under the profiler: wall and device ms, kernels, idle share
    data, buckets = program.prepare_inputs(ds, re_ds, mf_ds)
    profiled = _profiled(torch, lambda: program.step(data, buckets, state))
    _log(f"a. one fused sweep profiled ({card}): " + json.dumps(profiled))

    # GameEstimator.fit on the same data, same coordinates in the same order
    est = _game_estimator(task, "AUTO", sweeps)
    est.coordinate_configs = dict(est.coordinate_configs, mf=MatrixFactorizationCoordinateConfig(
        "user", "item", num_latent_factors=k, num_alternations=shape["alternations"],
        optimization=CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType.AUTO, max_iterations=10),
            l2_weight=shape["mf_l2"])))
    warm_est = _game_estimator(task, "AUTO", 1)
    warm_est.coordinate_configs = est.coordinate_configs
    warm_est.fit(ds)  # warm up outside the times
    cd = _game_fit(torch, "a. the same model through GameEstimator.fit", est, ds, sweeps)
    _log(f"a. seconds a sweep ({card}): fused {main['seconds_per_sweep']:.4f} "
         f"({json.dumps([round(r['seconds'], 4) for r in per_sweep])}), GameEstimator.fit "
         f"{cd['seconds_per_sweep']:.4f} (solves {json.dumps(cd['per_sweep'])}, rescoring "
         f"{cd['rescoring_per_sweep']:.4f}, host rest {cd['host_rest_per_sweep']:.4f}); "
         f"final training loss fused {main['losses'][-1]:.8g}, CD {cd['loss_per_sweep'][-1]:.8g}")

    # held-out AUC of the whole model above the fixed effect's alone
    model = dist.state_to_game_model(program, state, ds, re_datasets=re_ds)
    labels = held_ds.host_array("labels")
    full = (model.score(held_ds) + held_ds.offsets).double().cpu().numpy()
    fe_only = (model.get("global").score_dataset(held_ds) + held_ds.offsets).double().cpu().numpy()
    aucs = {"model": local_metrics.area_under_roc_curve(full, labels),
            "fixed effect alone": local_metrics.area_under_roc_curve(fe_only, labels)}
    _log(f"a. held-out AUC ({card}): " + json.dumps(aucs))
    assert np.isfinite(full).all() and aucs["model"] > aucs["fixed effect alone"], aucs

    # the state through model I/O and back, bitwise; a warm-started sweep
    with tempfile.TemporaryDirectory(prefix="fused-", dir=Path(__file__).resolve().parent
                                     / "build") as tmp:
        maps = {shard: IndexMap({feature_key(f"{shard}{j}"): j for j in range(x.shape[1])})
                for shard, x in ds.feature_shards.items()}
        t0 = time.perf_counter()
        save_game_model(tmp, model, maps, sparsity_threshold=0.0)
        loaded = load_game_model(tmp, maps, dtype=np.float32, device=dev)
        io_s = time.perf_counter() - t0
    back = dist.game_model_to_state(program, loaded, ds, re_datasets=re_ds, mf_datasets=mf_ds)
    tensors = {"fe": (state.fe_coefficients, back.fe_coefficients)}
    for group in ("re_tables", "mf_rows", "mf_cols"):
        for name, v in getattr(state, group).items():
            tensors[f"{group}/{name}"] = (v, getattr(back, group)[name])
    bitwise = {key: bool(torch.equal(a, b)) for key, (a, b) in tensors.items()}
    _log(f"a. state -> model_io save -> load -> state in {io_s:.2f} s, bitwise: "
         + json.dumps(bitwise))
    assert all(bitwise.values()), bitwise
    warm = _fused_run(torch, "a. warm-started sweep from the reloaded state", program, ds,
                      re_ds, mf_ds, 1, state=back)
    assert warm["losses"][0] <= main["losses"][-1] * (1 + 1e-5), (warm["losses"], main["losses"])

    # B1 and its reduce on the fused step's own fixed-effect batch: the
    # trained coefficients, the residual offsets of every other coordinate
    scores = program._coordinate_scores(data, state)
    offsets = program._sum_scores(data["offsets"], scores, "global").contiguous()
    x = data["features"]["global"]
    batch = LabeledPointBatch(features=x, labels=data["labels"], offsets=offsets,
                              weights=data["weights"])
    w = state.fe_coefficients.contiguous()
    n, d = x.shape
    loss = LogisticLoss()
    r = torch.rand(n, device=dev)
    # the data term: at the optimum the L2 term would cancel X'r to noise
    kw = dict(l2_weight=0.0)
    path = {"fused_glm": dict(_path_check(
        torch, "fused_glm on the fused step's fixed effect",
        lambda: fused_glm.fused_value_and_gradient(loss, w, batch, **kw),
        lambda: fused_glm.fused_value_and_gradient_reference(loss, w, batch, **kw),
        lambda: (torch.matmul(x, w), torch.matmul(r, x)), (1e-5, 1e-4),
        n * d * 4 + 12 * n + 8 * d + 8, x.shape),
        launches=main["launches"]["fused_glm"], evaluations=main["fe_evaluations"],
        per_sweep=[r_["b1_launches"] for r_ in per_sweep])}
    b1_args = (loss, x, batch.labels, batch.offsets, batch.weights, w, None)
    path["fused_glm_reduce"] = dict(
        _reduce_entry(torch, "fused_glm_reduce on the fused step's fixed effect",
                      lambda: fused_glm.fused_partials(*b1_args), fused_glm.reduce_partials,
                      fused_glm.reduce_partials_reference),
        launches=main["launches"]["fused_glm_reduce"])
    _log(f"a. B1 on the fused step's fixed effect [{n}, {d}] ({card}): "
         + json.dumps({key: {f: v[f] for f in ("max_abs_err", "worst_err_share_of_limit", "ms",
                                               "plain_ms", "bound_ms", "library_ms")}
                       for key, v in path.items() if "worst_err_share_of_limit" in v}))
    fused_summary = {"seconds_per_sweep": main["seconds_per_sweep"],
                     "cd_seconds_per_sweep": cd["seconds_per_sweep"], "profiled_sweep": profiled}
    del main, cd, warm, model, loaded, back, data, buckets, state, scores, offsets, batch
    del ds, held_ds, re_ds, mf_ds, x, r, b1_args
    torch.cuda.empty_cache()

    # b. the sparse program at phase 9's shapes: a sparse fixed effect with a
    # compact per-user effect on the same shard, then (the dry run's second
    # program at full width) with an INDEX_MAP per-user effect on a dense
    # shard whose entries are half zero
    cfg = FUSED["sparse"]
    t0 = time.perf_counter()
    part, _ = _sparse_game_arrays(np, seed, cfg["n"], cfg["d"], cfg["per_row"], cfg["users"])
    rng = np.random.default_rng(seed + 21)
    dense = rng.standard_normal((cfg["n"], cfg["dense_d"]), dtype=np.float32)
    dense[rng.uniform(size=dense.shape) < cfg["zero_share"]] = 0.0
    shard = SparseShard(rows=part["rows"].astype(np.int64), cols=part["cols"].astype(np.int64),
                        vals=part["vals"], num_samples=part["n"], feature_dim=cfg["d"])
    sds = build_game_dataset(labels=part["labels"],
                             feature_shards={"global": shard, "per_entity": dense},
                             entity_keys={"user": part["users"]}, device=dev)
    del part, dense
    programs = {
        "b. sparse fixed effect + compact per-user": (
            _fused_program(k=None, re_types=("user",), re_shard="global", projector="INDEX_MAP",
                           task="LINEAR_REGRESSION"),
            {"user": build_random_effect_dataset(sds, "user", "global")}),
        "b. sparse fixed effect + INDEX_MAP per-user on a dense shard": (
            _fused_program(k=None, re_types=("user",), projector="INDEX_MAP",
                           task="LINEAR_REGRESSION"),
            {"user": build_random_effect_dataset(sds, "user", "per_entity",
                                                 projector_type=ProjectorType.INDEX_MAP)}),
    }
    torch.cuda.synchronize()
    _log(f"b. fused sparse data n={cfg['n']} d={cfg['d']}, {cfg['per_row']} Zipf columns a "
         f"row, {cfg['users']} users, a dense [{cfg['n']}, {cfg['dense_d']}] shard half zero; "
         f"compact K = {programs['b. sparse fixed effect + compact per-user'][1]['user'].table_width}"
         f": {time.perf_counter() - t0:.2f} s")
    sparse_runs, checks, compact_checks = {}, [], []
    for label, (prog, res) in programs.items():
        _fused_run(torch, f"{label}, warm-up", prog, sds, res, None, 1)
        # phase 9's model at this size: its objective falls, its training
        # loss need not (the compact blocks' penalty trades against it)
        run = sparse_runs[label] = _fused_run(torch, label, prog, sds, res, None, cfg["sweeps"],
                                              loss_falls=False)
        state = run["result"].state
        data, _ = prog.prepare_inputs(sds, res)
        off = prog._sum_scores(data["offsets"], prog._coordinate_scores(data, state), "global")
        fe_batch, _ = prog._primary_fe_batch(data, off, data["weights"])
        checks += _fe_gather_checks(torch, f"fused {label}", fe_batch, state.fe_coefficients)
        if "re_sparse" in data:
            compact_checks.append(_compact_check(
                torch, f"fused {label}: compact scores", data["re_sparse"]["user"],
                state.re_tables["user"].float().contiguous()))
        del state, data, off, fe_batch
    launches = {key: sum(r["launches"][key] for r in sparse_runs.values())
                for key in ("rows", "segments", "chunks", "compact")}
    _log(f"b. the gathers on the fused sparse programs' own inputs ({card}): "
         + json.dumps(checks + compact_checks))
    for label, run in sparse_runs.items():
        _log(f"{label} ({card}): seconds a sweep {run['seconds_per_sweep']:.4f}, launches "
             + json.dumps(run["launches"]))
    chunked = [c for c in checks if c["chunk_rows"]]
    assert chunked, "the Zipf-hot columns should take the chunk kernel"
    path["sparse_gather"] = {
        "launches": launches["rows"] + launches["segments"] - launches["compact"],
        "row_kernel": launches["rows"], "segment_kernel": launches["segments"],
        "compact_scoring": launches["compact"], "checks": checks}
    path["sparse_gather_chunks"] = {"launches": launches["chunks"], "checks": chunked}
    path["sparse_gather_compact"] = {"launches": launches["compact"], "checks": compact_checks}
    fused_summary["sparse_seconds_per_sweep"] = {label: run["seconds_per_sweep"]
                                                 for label, run in sparse_runs.items()}
    del sparse_runs, programs, sds, shard
    torch.cuda.empty_cache()

    # c. a small fused sweep on the card in f32 against the CPU in f64, from
    # the same state
    small = FUSED["small"]
    arrays, _ = _game_arrays(np, seed + 22, **small)
    start, got = None, {}
    for where, dtype in ((dev, None), (torch.device("cpu"), np.float64)):
        sds = _game_dataset(arrays, task, where, dtype=dtype)
        res = {"user": build_random_effect_dataset(sds, "user", "per_entity",
                                                   bucket_sizes=(GAME["cap"],))}
        mfs = {"mf": build_mf_dataset(sds, "user", "item")}
        prog = _fused_program(k=small["k"], re_types=("user",))
        if start is None:
            start = convert.train_state_to_numpy(prog.init_state(sds, res, mfs))
        state = convert.train_state_from_numpy(
            {key: ({n_: a.astype(dtype or np.float32) for n_, a in v.items()}
                   if isinstance(v, dict) else v.astype(dtype or np.float32))
             for key, v in start.items()}, device=where)
        out = dist.train_distributed(prog, sds, res, mf_datasets=mfs, num_iterations=1,
                                     state=state).state
        got[where.type] = convert.train_state_to_numpy(out)
    gaps = {}
    for key in ("fe_coefficients", "re_tables/user", "mf_rows/mf", "mf_cols/mf"):
        group, _, name = key.partition("/")
        a, b = (got[w_][group][name] if name else got[w_][group] for w_ in (dev.type, "cpu"))
        gaps[key] = (float(np.abs(a - b).max()), float(np.abs(b).max()))
    # phase 7e's measure: the largest difference over the whole state
    # against 1e-3 of its largest coefficient
    gap, scale = max(g for g, _ in gaps.values()), max(s for _, s in gaps.values())
    _log(f"c. small fused sweep n={small['n']} (FE + per-user + MF k={small['k']}): card f32 "
         f"vs cpu f64 max |dw| {gap:.3g} (max |w| {scale:.3g}, limit 1e-3·max|w|); by tensor "
         f"(max |d|, max |w|) {json.dumps(gaps)}")
    assert gap <= 1e-3 * scale, gaps
    assert all(v["launches"] > 0 for v in path.values()), {key: v["launches"]
                                                           for key, v in path.items()}
    path["fused_glm"]["summary"] = fused_summary
    return path


#: phase 12, the fused program over a data-axis mesh (``torch.distributed``):
#: phase 11's flagship (bench.py:541-560 widths, none cut, with phase 10's MF
#: k=16 coordinate), phase 11's sparse program, and the GAME drivers on the
#: flagship's Avro cut to a quarter of its rows (``FLAGSHIP_AVRO["cut"]``)
MESH = dict(FUSED["flagship"], sparse_sweeps=2, rank_timeout_s=420)


def _mesh_b1_checks(torch, tag: str, program, data, state) -> dict:
    """B1 and its reduce on a rank's own block of the fused step's fixed
    effect (the trained coefficients, the residual offsets), against their
    plain versions, twice bitwise, at phase 3's f32 limits."""
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.ops.losses import LogisticLoss

    scores = program._coordinate_scores(data, state)
    offsets = program._sum_scores(data["offsets"], scores, "global").contiguous()
    x = data["features"]["global"]
    batch = LabeledPointBatch(features=x, labels=data["labels"], offsets=offsets,
                              weights=data["weights"])
    w = state.fe_coefficients.contiguous()
    n, d = x.shape
    loss = LogisticLoss()
    r = torch.rand(n, device=x.device)
    kw = dict(l2_weight=0.0)
    out = {"fused_glm": _path_check(
        torch, f"{tag}: fused_glm on the rank's block",
        lambda: fused_glm.fused_value_and_gradient(loss, w, batch, **kw),
        lambda: fused_glm.fused_value_and_gradient_reference(loss, w, batch, **kw),
        lambda: (torch.matmul(x, w), torch.matmul(r, x)), (1e-5, 1e-4),
        n * d * 4 + 12 * n + 8 * d + 8, x.shape)}
    args = (loss, x, batch.labels, batch.offsets, batch.weights, w, None)
    out["fused_glm_reduce"] = _reduce_entry(
        torch, f"{tag}: fused_glm_reduce on the rank's block",
        lambda: fused_glm.fused_partials(*args), fused_glm.reduce_partials,
        fused_glm.reduce_partials_reference)
    return out


def _mesh_flagship(np, seed: int, dev):
    """Phase 11's flagship data on ``dev``: (dataset, held-out dataset,
    re_datasets, mf_datasets)."""
    from photon_ml_torch.algorithm.mf_coordinate import build_mf_dataset
    from photon_ml_torch.data.game_data import build_random_effect_dataset

    train, held = _game_arrays(np, seed + 20, **MESH)
    ds = _game_dataset(train, "LOGISTIC_REGRESSION", dev)
    held_ds = _game_dataset(held, "LOGISTIC_REGRESSION", dev, vocabs=ds.entity_vocabs)
    re_ds = {t: build_random_effect_dataset(ds, t, "per_entity", bucket_sizes=(GAME["cap"],))
             for t in ("user", "item")}
    return ds, held_ds, re_ds, {"mf": build_mf_dataset(ds, "user", "item")}


def _mesh_rank_main(rank: int, world: int, tmp: str, seed: int, backend: str,
                    device_type: str, device_index: int) -> None:
    """One rank of phase 12(b): the flagship mesh program twice (4 sweeps
    each, the training loss non-increasing), B1 and its reduce on rank 0's
    own block; writes its results to ``tmp/rank<r>.json`` and the state to
    ``tmp/state<r>.npz``. A module function, so a spawned process runs it."""
    import datetime

    import numpy as np
    import torch

    from photon_ml_torch import convert
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh

    try:
        dev = torch.device(device_type, device_index) if device_type == "cuda" \
            else torch.device(device_type)
        multihost.initialize(f"file://{tmp}/rendezvous", world, rank, local_rank=device_index,
                             device=dev, backend=backend,
                             timeout=datetime.timedelta(seconds=MESH["rank_timeout_s"]))
        mesh = make_mesh()
        ds, _, re_ds, mf_ds = _mesh_flagship(np, seed, dev)
        program = _fused_program(k=MESH["k"], alternations=MESH["alternations"],
                                 mf_l2=MESH["mf_l2"], mesh=mesh)
        _fused_run(torch, f"b. rank {rank} warm-up", program, ds, re_ds, mf_ds, 1, mesh=mesh)
        runs = [_fused_run(torch, f"b. rank {rank}/{world} {backend} run {i}", program, ds,
                           re_ds, mf_ds, MESH["sweeps"], mesh=mesh) for i in (1, 2)]
        states = [convert.train_state_to_numpy(r.pop("result").state) for r in runs]
        flat = [_flat_state(s) for s in states]
        bitwise = all(np.array_equal(flat[0][k], flat[1][k]) for k in flat[0])
        out = {"rank": rank, "backend": backend, "device": str(dev), "bitwise_repeat": bitwise,
               "runs": runs}
        if rank == 0:
            data, buckets = program.prepare_inputs(ds, re_ds, mf_ds)
            state = convert.train_state_from_numpy(states[0], device=dev)
            data, _, state = program.shard_inputs(mesh, data, buckets, state)
            out["checks"] = _mesh_b1_checks(torch, f"b. rank 0 of {world}", program, data,
                                            state)
        np.savez(Path(tmp) / f"state{rank}.npz", **flat[0])
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out, default=float))
    finally:
        multihost.shutdown()


def _flat_state(state: dict) -> dict:
    out = {"fe_coefficients": state["fe_coefficients"]}
    for group in ("re_tables", "mf_rows", "mf_cols", "extra_fe"):
        out.update({f"{group}/{k}": v for k, v in state[group].items()})
    return out


def _state_gap(np, a: dict, b: dict) -> tuple[float, float, bool]:
    """(max |a - b| over the state, max |b|, bitwise equal)."""
    gap = max(float(np.abs(a[k] - b[k]).max()) for k in b)
    scale = max(float(np.abs(b[k]).max()) for k in b)
    return gap, scale, all(np.array_equal(a[k], b[k]) for k in b)


def _two_ranks(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 12(b): two ranks of the flagship mesh program, NCCL on two
    cards where there are two, else two processes on the one card over gloo
    with CUDA tensors (NCCL refuses two ranks on one device)."""
    two_cards = dev.type == "cuda" and torch.cuda.device_count() >= 2
    backend = "nccl" if two_cards else "gloo"
    with tempfile.TemporaryDirectory(prefix="mesh-", dir=Path(__file__).resolve().parent
                                     / "build") as tmp:
        ctx = _processes()
        procs = [ctx.Process(target=_mesh_rank_main,
                             args=(r, 2, tmp, seed, backend, dev.type, r if two_cards else 0))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(MESH["rank_timeout_s"])
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(30)
        assert not alive, f"b. {len(alive)} ranks still running after {MESH['rank_timeout_s']} s"
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
        seconds = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(2)]
        states = [dict(np.load(Path(tmp) / f"state{r}.npz")) for r in range(2)]
    return {"backend": backend, "two_cards": two_cards, "seconds": seconds, "ranks": ranks,
            "states": states}


def _mesh_drivers(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """Phase 12(d): the GAME training and scoring drivers with and without
    ``--distributed`` (one process: a group of one) on the flagship's cut
    Avro. Index maps, metadata and id-info byte-identical;
    coefficients within 1e-3 of their largest (the one path's packed kernel
    against the other's B1, in f32); the written scores bitwise equal to the
    same model's in-process scores. The Avro is ``_flagship_avro``'s cut one."""
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model, read_scores
    from photon_ml_torch.transformers import GameTransformer

    avro = _flagship_avro(np, seed, tmp)
    n, nv, write_s = avro["n"], avro["held_out"], avro["write_seconds"]
    shards = ["--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
              "--feature-shard-configurations",
              "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
    re_spec = "feature.shard=per_entity,reg.weights=1,optimizer=NEWTON,max.iter=10," \
              "random.effect.type="
    runs, seconds = {}, {}
    for name, extra in (("plain", []), ("distributed", ["--distributed"])):
        t0 = time.perf_counter()
        # no validation evaluators: the coordinate-descent path tracks its
        # best model per coordinate update and the fused one per sweep, so
        # both save their final models only when nothing is tracked
        runs[name] = game_training_driver.main([
            "--input-data-path", str(avro["train"]),
            "--root-output-dir", str(tmp / name), "--task-type", "LOGISTIC_REGRESSION", *shards,
            "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--coordinate-configurations", f"name=per_user,{re_spec}userId",
            "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
            "--coordinate-descent-iterations", "2", *extra],
            device=None if dev.type == "cuda" else dev)
        torch.cuda.synchronize()
        seconds[f"train {name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        game_scoring_driver.main([
            "--input-data-path", str(avro["validation"]), "--model-input-dir",
            str(tmp / name / "best"), "--output-dir", str(tmp / f"scores-{name}"), *shards,
            "--evaluators", "AUC", *extra], device=None if dev.type == "cuda" else dev)
        torch.cuda.synchronize()
        seconds[f"score {name}"] = time.perf_counter() - t0
    assert runs["distributed"]["distributed"] and not runs["plain"]["distributed"]
    # the files that do not hold coefficients are byte-identical
    same = {}
    for sub in ("index-maps", "best"):
        for f in sorted((tmp / "plain" / sub).rglob("*")):
            rel = f.relative_to(tmp / "plain")
            if f.is_file() and (sub == "index-maps" or f.name in ("id-info",
                                                                  "model-metadata.json")):
                same[str(rel)] = (tmp / "distributed" / rel).read_bytes() == f.read_bytes()
    assert same and all(same.values()), same
    maps = IndexMap.load_directory(tmp / "plain" / "index-maps")
    models = {name: load_game_model(tmp / name / "best", maps, device=dev) for name in runs}
    gaps = {}
    for cid, m in models["plain"].models.items():
        a = models["distributed"].get(cid)
        t_plain = m.glm.coefficients.means if hasattr(m, "glm") else m.coefficients
        t_dist = a.glm.coefficients.means if hasattr(a, "glm") else a.coefficients
        gaps[cid] = (float((t_dist.double() - t_plain.double()).abs().max()),
                     float(t_plain.double().abs().max()))
    assert all(g <= 1e-3 * s for g, s in gaps.values()), gaps
    # the scores written by the distributed scoring run against the same
    # model scored in process
    cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
           "per_entity": FeatureShardConfiguration(feature_bags=("perEntityFeatures",),
                                                   has_intercept=False)}
    model = models["distributed"]
    val = read_merged(avro["validation"], cfg, index_maps=maps,
                      random_effect_id_columns=("itemId", "userId"),
                      entity_vocabs={m.random_effect_type: m.entity_keys
                                     for m in model.models.values()
                                     if hasattr(m, "entity_keys")}, device=dev).dataset
    in_process = GameTransformer(model).transform(val).scores
    got = np.asarray([r["predictionScore"]
                      for r in read_scores(tmp / "scores-distributed" / "scores")])
    bitwise = bool(np.array_equal(got.astype(in_process.dtype), in_process))
    out = {"rows": [n, nv], "write_seconds": write_s, "seconds": seconds,
           "best_metric": {k: r["best_metric"] for k, r in runs.items()},
           "byte_identical": len(same), "coefficient_gaps": gaps,
           "written_scores_bitwise": bitwise}
    _log(f"d. the GAME drivers with and without --distributed at {n} + {nv} rows ({card}): "
         + json.dumps(out))
    assert bitwise, "the distributed scoring run's scores differ from the in-process ones"
    return out


def _mesh_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 12, the fused program over a data-axis mesh, printing as it
    goes. Returns, for each kernel this path runs, its launches here and its
    checks on the path's own inputs."""
    from photon_ml_torch import convert
    from photon_ml_torch.data.game_data import build_game_dataset, build_random_effect_dataset
    from photon_ml_torch.data.sparse_batch import SparseShard
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh
    from photon_ml_torch.parallel.scoring import DistributedScorer
    from photon_ml_torch.transformers import GameTransformer

    # a. one rank: a group of one over NCCL, the same data as phase 11(a)
    info = multihost.initialize(device=None if dev.type == "cuda" else dev)
    assert info.world_size == 1 and info.backend == ("nccl" if dev.type == "cuda" else "gloo"), \
        info
    mesh = make_mesh()
    t0 = time.perf_counter()
    ds, held_ds, re_ds, mf_ds = _mesh_flagship(np, seed, dev)
    torch.cuda.synchronize()
    _log(f"a. mesh flagship data (phase 11's) built: {time.perf_counter() - t0:.2f} s; "
         f"rank {info.rank}/{info.world_size} {info.backend} on {info.device}")
    program = _fused_program(k=MESH["k"], alternations=MESH["alternations"],
                             mf_l2=MESH["mf_l2"], mesh=mesh)
    one_device = _fused_program(k=MESH["k"], alternations=MESH["alternations"],
                                mf_l2=MESH["mf_l2"])
    _fused_run(torch, "a. mesh warm-up", program, ds, re_ds, mf_ds, 1, mesh=mesh)
    main = _fused_run(torch, "a. mesh flagship, one rank", program, ds, re_ds, mf_ds,
                      MESH["sweeps"], mesh=mesh)
    ref = _fused_run(torch, "a. the same model, mesh=None", one_device, ds, re_ds, mf_ds,
                     MESH["sweeps"])
    state = main.pop("result").state
    ref_state = ref.pop("result").state
    flat = _flat_state(convert.train_state_to_numpy(state))
    flat_ref = _flat_state(convert.train_state_to_numpy(ref_state))
    gap, scale, bitwise = _state_gap(np, flat, flat_ref)
    loss_gap = max(_rel_gap(a, b) for a, b in zip(main["losses"], ref["losses"]))
    # phase 14 runs the model axis against this run and the mesh=None one
    _SHARED["mesh_flagship"] = {"flat": flat, "flat_ref": flat_ref, "losses": main["losses"],
                                "losses_ref": ref["losses"]}
    per_sweep = main["sweeps"]
    assert all(r["b1_launches"] == r["fe_evaluations"] > 0 for r in per_sweep), per_sweep
    _log(f"a. one rank against mesh=None ({card}): state max |dw| {gap:.3g} (max |w| "
         f"{scale:.3g}, limit 1e-4·max|w|), training loss max rel gap {loss_gap:.3g} (limit "
         f"1e-5), bitwise {bitwise}; seconds a sweep mesh {main['seconds_per_sweep']:.4f}, "
         f"mesh=None {ref['seconds_per_sweep']:.4f}; collectives a sweep "
         + json.dumps([r["collectives"] for r in per_sweep]))
    assert gap <= 1e-4 * scale and loss_gap <= 1e-5, (gap, scale, loss_gap)
    data, buckets = program.prepare_inputs(ds, re_ds, mf_ds)
    data, buckets, _ = program.shard_inputs(mesh, data, buckets, state)
    profiled = _profiled(torch, lambda: program.step(data, buckets, state))
    _log(f"a. one mesh sweep profiled ({card}): " + json.dumps(profiled))
    checks = _mesh_b1_checks(torch, "a. one rank", program, data, state)
    path = {"fused_glm": dict(checks["fused_glm"], launches=main["launches"]["fused_glm"],
                              evaluations=main["fe_evaluations"],
                              per_sweep=[r["b1_launches"] for r in per_sweep]),
            "fused_glm_reduce": dict(checks["fused_glm_reduce"],
                                     launches=main["launches"]["fused_glm_reduce"])}
    _log(f"a. B1 on the rank's block ({card}): " + json.dumps(
        {k: {f: v.get(f) for f in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
         for k, v in checks.items()}))
    summary = {"seconds_per_sweep": main["seconds_per_sweep"],
               "one_device_seconds_per_sweep": ref["seconds_per_sweep"],
               "bitwise_one_device": bitwise, "state_gap": gap,
               "collectives_per_sweep": per_sweep[-1]["collectives"], "profiled_sweep": profiled}
    del data, buckets

    # b. two ranks
    two = _two_ranks(torch, np, seed, dev, card)
    states = two.pop("states")
    gap2, _, _ = _state_gap(np, states[0], flat)
    ranks_equal = all(np.array_equal(states[0][k], states[1][k]) for k in states[0])
    for r in two["ranks"]:
        for run in r["runs"]:
            losses = run["losses"]
            assert all(b <= a * (1 + 1e-5) for a, b in zip(losses, losses[1:])), losses
    repeat = all(r["bitwise_repeat"] for r in two["ranks"])
    b1 = two["ranks"][0]["checks"]
    # the f32 sum order changes with the rank count: each L-BFGS and lane
    # solve amplifies the last-bit differences, as the card against the CPU
    # does (phase 11(c)), so the two-rank state is held at 1e-3·max|w|
    _log(f"b. two ranks, backend={two['backend']} ({'two cards' if two['two_cards'] else 'both on the one card'}; "
         f"{card}): state against (a) max |dw| {gap2:.3g} (limit 1e-3·max|w| = "
         f"{1e-3 * scale:.3g}), ranks' states equal {ranks_equal}, two runs bitwise "
         f"{repeat}, {two['seconds']:.2f} s with process start; seconds a sweep "
         + json.dumps([run["seconds_per_sweep"] for r in two["ranks"] for run in r["runs"]])
         + "; collectives a sweep (rank 0) "
         + json.dumps(two["ranks"][0]["runs"][0]["sweeps"][-1]["collectives"])
         + "; B1 on rank 0's block " + json.dumps(
             {k: {f: v.get(f) for f in ("max_abs_err", "ms", "plain_ms")}
              for k, v in b1.items()}))
    assert gap2 <= 1e-3 * scale and ranks_equal and repeat, (gap2, ranks_equal, repeat)
    summary["two_ranks"] = {"backend": two["backend"], "two_cards": two["two_cards"],
                            "state_gap": gap2, "bitwise_repeat": repeat,
                            "seconds_per_sweep": [run["seconds_per_sweep"]
                                                  for run in two["ranks"][0]["runs"]]}
    path["fused_glm"]["two_ranks_rank0"] = b1["fused_glm"]

    # c. scoring: GameTransformer(mesh=...) on the held-out rows
    model = dist.state_to_game_model(program, state, ds, re_datasets=re_ds)
    one = GameTransformer(model).transform(held_ds).scores
    on_mesh = GameTransformer(model, mesh=mesh).transform(held_ds).scores
    score_gap = float(np.abs(on_mesh - one).max() / np.abs(one).max())
    labels = held_ds.host_array("labels")
    device_auc = DistributedScorer(model, mesh).evaluate_dataset(held_ds, ["AUC"])["AUC"]
    host_auc = local_metrics.area_under_roc_curve(on_mesh, labels)
    fe_only = (model.get("global").score_dataset(held_ds) + held_ds.offsets).cpu().numpy()
    fe_auc = local_metrics.area_under_roc_curve(fe_only, labels)
    _log(f"c. mesh scoring of {held_ds.num_samples} held-out rows, a quarter of unseen users "
         f"({card}): max rel gap to the one-device transform {score_gap:.3g} (limit 1e-5); "
         f"device AUC {device_auc:.8f}, host AUC {host_auc:.8f} (limit 1e-6), fixed effect "
         f"alone {fe_auc:.6f}")
    assert score_gap <= 1e-5 and abs(device_auc - host_auc) <= 1e-6 and host_auc > fe_auc, \
        (score_gap, device_auc, host_auc, fe_auc)
    summary["scoring"] = {"rel_gap": score_gap, "device_auc": device_auc, "host_auc": host_auc}
    del program, one_device, state, ref_state, model, ds, held_ds, re_ds, mf_ds
    torch.cuda.empty_cache()

    # the sparse program of phase 11(b) over the one-rank mesh: G1 on the
    # rank's rows and compact scoring
    cfg = FUSED["sparse"]
    part, _ = _sparse_game_arrays(np, seed, cfg["n"], cfg["d"], cfg["per_row"], cfg["users"])
    shard = SparseShard(rows=part["rows"].astype(np.int64), cols=part["cols"].astype(np.int64),
                        vals=part["vals"], num_samples=part["n"], feature_dim=cfg["d"])
    sds = build_game_dataset(labels=part["labels"], feature_shards={"global": shard},
                             entity_keys={"user": part["users"]}, device=dev)
    del part
    prog = _fused_program(k=None, re_types=("user",), re_shard="global", projector="INDEX_MAP",
                          task="LINEAR_REGRESSION", mesh=mesh)
    res = {"user": build_random_effect_dataset(sds, "user", "global")}
    label = "a. sparse fixed effect + compact per-user over the mesh"
    _fused_run(torch, f"{label}, warm-up", prog, sds, res, None, 1, loss_falls=False, mesh=mesh)
    run = _fused_run(torch, label, prog, sds, res, None, MESH["sparse_sweeps"], loss_falls=False,
                     mesh=mesh)
    sstate = run.pop("result").state
    data, buckets = prog.prepare_inputs(sds, res)
    data, _, _ = prog.shard_inputs(mesh, data, buckets, sstate)
    off = prog._sum_scores(data["offsets"], prog._coordinate_scores(data, sstate), "global")
    fe_batch, _ = prog._primary_fe_batch(data, off, data["weights"])
    gchecks = _fe_gather_checks(torch, label, fe_batch, sstate.fe_coefficients)
    cchecks = [_compact_check(torch, f"{label}: compact scores", data["re_sparse"]["user"],
                              sstate.re_tables["user"].float().contiguous())]
    launches = run["launches"]
    _log(f"{label} ({card}): seconds a sweep {run['seconds_per_sweep']:.4f}, launches "
         + json.dumps(launches) + ", collectives " + json.dumps(run["collectives"]))
    path["sparse_gather"] = {
        "launches": launches["rows"] + launches["segments"] - launches["compact"],
        "row_kernel": launches["rows"], "segment_kernel": launches["segments"],
        "compact_scoring": launches["compact"], "checks": gchecks}
    path["sparse_gather_chunks"] = {"launches": launches["chunks"],
                                    "checks": [c for c in gchecks if c["chunk_rows"]]}
    path["sparse_gather_compact"] = {"launches": launches["compact"], "checks": cchecks}
    summary["sparse_seconds_per_sweep"] = run["seconds_per_sweep"]
    del prog, res, sds, shard, data, buckets, sstate, fe_batch, off
    torch.cuda.empty_cache()

    # d. the drivers (their outputs stay for phase 14(e) until the script ends)
    tmp = Path(tempfile.mkdtemp(prefix="mesh-drivers-", dir=_SHARED.get(
        "dir", Path(__file__).resolve().parent / "build")))
    summary["drivers"] = _mesh_drivers(torch, np, seed, dev, card, tmp)
    _SHARED["mesh_drivers"] = tmp
    multihost.shutdown()
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    path["fused_glm"]["summary"] = summary
    return path


#: phase 13, partitioned I/O (``io/partitioned_reader.py``): two ranks on the
#: one card (gloo with CUDA tensors), each decoding about half of (a) the
#: flagship's cut Avro (``_flagship_avro``: 2^15 rows, users clustered by
#: file, items spanning the ranks), (b) phase 9's sparse shape written as
#: Avro (n = 2^16 rows of 16 Zipf columns over d = 10^6, a dense [2^16, 16]
#: per-user shard, users clustered), (c) two of its held-out part files
#: (2^11 rows) as one container, the blocks mode, (d) the 2^13 held-out rows;
#: (e) the GAME drivers with ``--partitioned-io`` on the same Avro
PARTITIONED = dict(sweeps=4, sparse_sweeps=2, cap=128, hot_cols=256, sparse_parts=8,
                   rank_timeout_s=600)


def _partitioned_cfg(kind: str) -> dict:
    """The shard configurations of phase 13: the flagship's dense ``global``
    (the reader adds the intercept) or phase 9's sparse one as an ELL or a
    hybrid (256-column head) shard, each with the dense ``per_entity``."""
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration

    glob = {"flagship": FeatureShardConfiguration(feature_bags=("features",)),
            "ell": FeatureShardConfiguration(feature_bags=("features",), sparse=True),
            "hybrid": FeatureShardConfiguration(feature_bags=("features",), sparse=True,
                                                hybrid=True,
                                                hybrid_hot_cols=PARTITIONED["hot_cols"])}[kind]
    return {"global": glob, "per_entity": FeatureShardConfiguration(
        feature_bags=("perEntityFeatures",), has_intercept=False)}


def _write_sparse_part(args) -> float:
    """One part file of phase 13(b)'s sparse Avro (name-term ``features``,
    16 ``perEntityFeatures``, the user id in the metadata map); seconds. A
    module function, so a process pool can run it."""
    path, cols, vals, x_re, y, users, offset = args
    cols, vals, x_re = cols.tolist(), vals.tolist(), x_re.tolist()
    y, users = y.tolist(), users.tolist()
    return _write_avro(path, _game_avro_schema(), len(y), lambda i: {
        "uid": str(offset + i), "label": y[i],
        "features": [{"name": f"c{c}", "term": "", "value": v}
                     for c, v in zip(cols[i], vals[i])],
        "perEntityFeatures": _ntv("e", x_re[i]), "weight": 1.0, "offset": 0.0,
        "foldId": None, "metadataMap": {"userId": users[i]}})


def _sparse_avro_jobs(np, seed: int, base: Path) -> tuple:
    """Phase 9's training rows (bench.py:721's shape, none cut) as Avro with a
    dense 16-wide per-user shard and a planted per-user term in the labels,
    rows sorted by user into ``PARTITIONED["sparse_parts"]`` files, each
    user's rows in one file: (``_write_sparse_part`` jobs, {"path", "n"})."""
    cfg = SPARSE_GAME
    part, _ = _sparse_game_arrays(np, seed, cfg["n"], cfg["d"], cfg["per_row"], cfg["users"])
    n, k = part["n"], cfg["per_row"]
    rng = np.random.default_rng(seed + 31)
    x_re = rng.standard_normal((n, 16), dtype=np.float32)
    users = part["users"]
    vocab, uidx = np.unique(users, return_inverse=True)
    w_user = (0.5 * rng.normal(size=(len(vocab), 16))).astype(np.float32)
    y = part["labels"] + np.einsum("nd,nd->n", x_re, w_user[uidx])
    order = np.argsort(users, kind="stable")
    cols, vals = part["cols"].reshape(n, k)[order], part["vals"].reshape(n, k)[order]
    x_re, y, users = x_re[order], y[order], users[order]
    parts = PARTITIONED["sparse_parts"]
    starts = np.append(np.flatnonzero(np.r_[True, users[1:] != users[:-1]]), n)
    bounds = [int(starts[np.searchsorted(starts, n * i // parts)]) for i in range(parts + 1)]
    jobs = [(os.path.join(base, f"part-{i:05d}.avro"), cols[lo:hi], vals[lo:hi], x_re[lo:hi],
             y[lo:hi], users[lo:hi], lo) for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]
    return jobs, {"path": base, "n": n}


def _sparse_avro(np, seed: int, base: Path) -> dict:
    """``_sparse_avro_jobs``' files (written by ``_start_prewrites``, else
    here under ``base`` by a pool): {"path", "n", "write_seconds",
    "background"}."""
    pre = _prewritten("sparse")
    if pre is not None:
        return dict(pre, write_seconds=sum(pre["part_seconds"]), background=True)
    jobs, info = _sparse_avro_jobs(np, seed, base)
    t0 = time.perf_counter()
    with _processes().Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        pool.map(_write_sparse_part, jobs)
    return dict(info, write_seconds=time.perf_counter() - t0, background=False)


def _blocks_container(src_files, dst: Path) -> dict:
    """``src_files``' container blocks copied, in order, into one file (the
    payloads inflated and deflated again, no record re-encoded)."""
    import zlib

    from photon_ml_torch.io import avro

    schema = avro.read_container_schema(src_files[0])
    dst.parent.mkdir(parents=True, exist_ok=True)
    blocks = []
    for f in src_files:
        with open(f, "rb") as inp:
            for count, size, offset in avro.scan_block_index(f):
                inp.seek(offset)
                blocks.append((count, zlib.decompress(inp.read(size), -15)))
    records = avro.write_container_blocks(dst, schema, blocks)
    return {"file": dst, "records": records, "blocks": len(blocks)}


def _partitioned_run(torch, label: str, program, parts, mesh, world: int, sweeps: int,
                     exchange) -> dict:
    """``train_partitioned`` with the launch and collective counters set to
    0 just before and read just after: seconds, losses (each finite and, the
    sweeps' training loss, non-increasing), launches and collectives."""
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import mesh as mesh_ops

    fused_glm.launches = fused_glm.reduce_launches = 0
    _reset_gather_counts()
    mesh_ops.counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = dist.train_partitioned(program, parts, mesh, world, num_iterations=sweeps,
                                    exchange=exchange)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = result.losses
    assert len(losses) == sweeps and all(math.isfinite(v) for v in losses), (label, losses)
    return {"run": label, "seconds": seconds, "seconds_per_sweep": seconds / sweeps,
            "losses": losses, "collectives": mesh_ops.counts.snapshot(),
            "launches": {"fused_glm": fused_glm.launches,
                         "fused_glm_reduce": fused_glm.reduce_launches, **_gather_counts()},
            "state": result.state}


def _timed(torch, fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _host_rows(np, part) -> dict:
    """A partitioned read's true rows, on the host (blocks against files)."""
    ds, n = part.result.dataset, part.partition.local_n
    out = {"labels": ds.host_array("labels")[:n], "offsets": ds.host_array("offsets")[:n],
           "weights": ds.host_array("weights")[:n], "uids": ds.unique_ids[:n]}
    out.update({f"shard/{k}": ds.host_array(f"shard/{k}")[:n] for k in ds.feature_shards})
    out.update({f"entity_idx/{k}": ds.host_array(f"entity_idx/{k}")[:n] for k in ds.entity_idx})
    out.update({f"vocab/{k}": np.asarray(v).astype(str) for k, v in ds.entity_vocabs.items()})
    return out


def _partitioned_paths(torch, np, rank: int, world: int, tmp: Path, dev, job: dict) -> dict:
    """Phase 13 (a)-(d) on one rank of a group of ``world``; writes what the
    parent compares into ``tmp`` and returns the rank's report."""
    from photon_ml_torch import convert
    from photon_ml_torch.data.game_data import (
        build_random_effect_dataset,
        build_random_effect_dataset_partitioned,
    )
    from photon_ml_torch.io.data_reader import read_merged
    from photon_ml_torch.io.model_io import save_game_model
    from photon_ml_torch.io.partitioned_reader import read_partitioned
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh
    from photon_ml_torch.parallel.scoring import DistributedScorer

    mesh = make_mesh()
    ex = multihost.default_exchange()
    report: dict = {"rank": rank, "reads": {}, "runs": {}, "checks": {}}
    cap = (PARTITIONED["cap"],)

    def read(label, path, cfg, re_cols, **kw):
        part, seconds = _timed(torch, lambda: read_partitioned(
            path, cfg, exchange=ex, random_effect_id_columns=re_cols, tag=label, device=dev,
            **kw))
        report["reads"][label] = {
            "mode": part.mode, "rows": part.partition.local_n,
            "bytes_decoded": part.bytes_decoded, "input_bytes_total": part.input_bytes_total,
            "seconds": seconds, "records_per_s": part.partition.local_n / seconds,
            "local_rows": list(part.partition.local_rows),
            "spanning": {k: int((v > 1).sum()) for k, v in part.entity_rank_presence.items()}}
        return part

    def full_read(label, path, cfg, re_cols):
        full, seconds = _timed(torch, lambda: read_merged(
            path, cfg, random_effect_id_columns=re_cols, device=dev))
        report["reads"][label].update(full_seconds=seconds,
                                      full_records_per_s=full.dataset.num_samples / seconds)
        return full

    def builders(part, re_types, tag):
        return {t: build_random_effect_dataset_partitioned(
            part.result.dataset, t, "per_entity", partition=part.partition, exchange=ex,
            bucket_sizes=cap, entity_rank_presence=part.entity_rank_presence.get(t),
            tag=f"{tag}/{t}") for t in re_types}

    def full_train(program, full, re_types, sweeps):
        res = {t: build_random_effect_dataset(full.dataset, t, "per_entity", bucket_sizes=cap)
               for t in re_types}
        return dist.train_distributed(program, full.dataset, res, mesh=mesh,
                                      num_iterations=sweeps)

    # a. the flagship: FE + per-user (twice, and the full read), then FE +
    # per-user + per-item (items span the ranks)
    cfg = _partitioned_cfg("flagship")
    re_cols = ("itemId", "userId")
    part = read("flagship", job["train"], cfg, re_cols)
    full = full_read("flagship", job["train"], cfg, re_cols)
    sweeps = PARTITIONED["sweeps"]
    for label, re_types in (("user", ("userId",)), ("user+item", ("userId", "itemId"))):
        program = _fused_program(k=None, re_types=re_types, mesh=mesh)
        res = builders(part, re_types, label)
        parts = {rank: (part.result.dataset, res)}
        runs = [_partitioned_run(torch, f"a. {label} run {i}", program, parts, mesh, world,
                                 sweeps, ex) for i in (1, 2) if i == 1 or label == "user"]
        states = [r.pop("state") for r in runs]
        flat = [_flat_state(convert.train_state_to_numpy(st)) for st in states]
        ref = full_train(program, full, re_types, sweeps)
        flat_ref = _flat_state(convert.train_state_to_numpy(ref.state))
        gap, scale, _ = _state_gap(np, flat[0], flat_ref)
        report["runs"][label] = dict(
            runs[0], bitwise_repeat=(len(flat) < 2 or all(np.array_equal(flat[0][k], flat[1][k])
                                                          for k in flat[0])),
            full_losses=ref.losses, state_gap=gap, state_scale=scale,
            loss_gaps=[_rel_gap(a, b) for a, b in zip(runs[0]["losses"], ref.losses)],
            seconds_per_sweep_runs=[r["seconds_per_sweep"] for r in runs])
        np.savez(tmp / f"state-{label}-{rank}.npz", **flat[0])
        if label == "user":
            data, _, state = dist.prepare_partitioned_inputs(program, parts, mesh, world,
                                                             state=states[0], exchange=ex)
            if rank == 0:
                report["checks"]["b1"] = _mesh_b1_checks(
                    torch, "13a. rank 0's partitioned block", program, data, state)
            model = dist.state_to_game_model(program, state, part.result.dataset,
                                             re_datasets=res)
            del data
    del full
    torch.cuda.empty_cache()

    # d. scoring the held-out rows with the FE + per-user model: each rank
    # its own block, no gather
    held = read("held-out", job["validation"], cfg, ("userId",),
                index_maps=part.result.index_maps, entity_vocabs=part.result.dataset.entity_vocabs)
    scorer = DistributedScorer(model, mesh)
    scores, seconds = _timed(torch, lambda: scorer.score_partitioned(
        {rank: held.result.dataset}, held.partition, exchange=ex)[rank])
    n_local = held.partition.local_n
    np.savez(tmp / f"scores-{rank}.npz", scores=scores,
             uids=held.result.dataset.unique_ids[:n_local])
    report["score_seconds"] = seconds
    if rank == 0:
        save_game_model(tmp / "model", model, part.result.index_maps, sparsity_threshold=0.0)
        for shard, imap in part.result.index_maps.items():
            imap.save(tmp / "index-maps", shard)
    del part, held, model, scorer
    torch.cuda.empty_cache()

    # b. phase 9's sparse shape: an ELL fixed effect, then a hybrid one
    report["layouts"] = {}
    gather_checks: list = []
    for kind in ("ell", "hybrid"):
        cfg = _partitioned_cfg(kind)
        part = read(f"sparse {kind}", job["sparse"], cfg, ("userId",))
        full = full_read(f"sparse {kind}", job["sparse"], cfg, ("userId",))
        shard = part.result.dataset.feature_shards["global"]
        policy = shard.hybrid_policy
        report["layouts"][kind] = {
            "ell_width": shard.ell_width, "flat_block_nnz": shard.flat_block_nnz,
            "hot_ids": None if policy is None else list(policy.hot_ids),
            "dim": shard.feature_dim, "local_rows": list(part.partition.local_rows)}
        if rank == 0:
            report["layouts"][kind]["full"] = _full_read_layout(
                np, full.dataset.feature_shards["global"], part.partition, world)
        program = _fused_program(k=None, re_types=("userId",), task="LINEAR_REGRESSION",
                                 mesh=mesh)
        res = builders(part, ("userId",), f"sparse {kind}")
        parts = {rank: (part.result.dataset, res)}
        run = _partitioned_run(torch, f"b. sparse {kind}", program, parts, mesh, world,
                               PARTITIONED["sparse_sweeps"], ex)
        state = run.pop("state")
        ref = full_train(program, full, ("userId",), PARTITIONED["sparse_sweeps"])
        gap, scale, _ = _state_gap(np, _flat_state(convert.train_state_to_numpy(state)),
                                   _flat_state(convert.train_state_to_numpy(ref.state)))
        report["runs"][f"sparse {kind}"] = dict(run, state_gap=gap, state_scale=scale,
                                                full_losses=ref.losses)
        data, _, state = dist.prepare_partitioned_inputs(program, parts, mesh, world,
                                                         state=state, exchange=ex)
        if rank == 0:
            off = program._sum_scores(data["offsets"], program._coordinate_scores(data, state),
                                      "global")
            batch, _ = program._primary_fe_batch(data, off, data["weights"])
            gather_checks += _fe_gather_checks(torch, f"13b. rank 0's {kind} block", batch,
                                               state.fe_coefficients)
        del data, part, full, res, state, ref
        torch.cuda.empty_cache()
    report["checks"]["gather"] = gather_checks

    # c. blocks mode: two part files as one container, against the files mode
    cfg = _partitioned_cfg("flagship")
    for label, path in (("blocks", job["blocks_file"]), ("blocks as files",
                                                         job["blocks_files"])):
        part = read(label, path, cfg, ("userId",))
        rows = _host_rows(np, part)
        np.savez(tmp / f"rows-{label.replace(' ', '-')}-{rank}.npz", **rows)
        (tmp / f"maps-{label.replace(' ', '-')}-{rank}.json").write_text(json.dumps(
            {k: list(v) for k, v in part.result.index_maps.items()}))
    return report


def _full_read_layout(np, shard, partition, world: int) -> dict:
    """The layout a full read of the whole input gives the sparse shard over
    a mesh of ``world`` ranks: the hot ids it ranks, the ELL auto width of
    its rows padded to the data axis, and the largest overflow beyond that
    width over the partition's row ranges (the flat block every rank pads
    to)."""
    from photon_ml_torch.data.sparse_batch import _ell_auto_width, rank_hot_columns

    rows, cols, _ = (np.asarray(a) for a in shard.coalesced())
    policy = shard.hybrid_policy
    hot = None
    if policy is not None:
        uniq, cnt = np.unique(cols, return_counts=True)
        hot = rank_hot_columns(uniq, cnt, len(cols), policy)
        pos = np.minimum(np.searchsorted(hot, cols), len(hot) - 1)
        rows = rows[hot[pos] != cols]
    n = int(shard.num_samples)
    counts = np.bincount(rows, minlength=n)
    padded = np.concatenate([counts, np.zeros((-n) % world, counts.dtype)])
    width = _ell_auto_width(padded, len(padded), int(counts.sum()))
    bounds = np.concatenate([[0], np.cumsum(partition.local_rows)])
    flat = max(int(np.maximum(counts[lo:hi] - width, 0).sum())
               for lo, hi in zip(bounds[:-1], bounds[1:]))
    return {"ell_width": int(width), "flat_block_nnz": flat,
            "hot_ids": None if hot is None else [int(c) for c in hot]}


def _partitioned_drivers(rank: int, tmp: Path, job: dict) -> dict:
    """Phase 13(e) on one rank: the GAME training driver with
    ``--partitioned-io --distributed`` on the flagship's cut Avro (with
    ``--trace-dir`` and ``--telemetry-dir``: phase 19(f)), then the scoring
    driver the same way on the held-out rows (each rank its part)."""
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver

    t0 = time.perf_counter()
    train = game_training_driver.main([
        "--input-data-path", job["train"], "--root-output-dir", str(tmp / "part"),
        "--task-type", "LOGISTIC_REGRESSION", *job["shards"], *job["coordinates"],
        "--coordinate-descent-iterations", "2", "--partitioned-io", "--distributed",
        "--trace-dir", str(tmp / "trace"), "--telemetry-dir", str(tmp / "telemetry")],
        device=job["device"])
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = game_scoring_driver.main([
        "--input-data-path", job["validation"], "--model-input-dir", str(tmp / "part" / "best"),
        "--output-dir", str(tmp / "scores-part"), *job["shards"], "--partitioned-io",
        "--distributed"], device=job["device"])
    return {"rank": rank, "train_seconds": train_s, "score_seconds": time.perf_counter() - t0,
            "timings": {k: v["total"] for k, v in train["timings"].items()},
            "score": {k: v for k, v in score.items() if k != "evaluations"}}


def _rank_traces(out: Path) -> dict:
    """Phase 19(f), from phase 13(e)'s training run: each rank's trace file,
    rank 0's journal, and its straggler report merged over both ranks
    naming every exchange tag either rank's trace shows a wait on."""
    from photon_ml_torch.telemetry import read_journal
    from photon_ml_torch.telemetry.tracing import normalize_tag

    files = sorted(p.name for p in (out / "trace").iterdir())
    assert files == ["trace-00000.json", "trace-00001.json"], files
    traces = [json.loads((out / "trace" / f).read_text()) for f in files]
    assert [t["otherData"]["rank"] for t in traces] == [0, 1]
    rows = read_journal(out / "telemetry" / "run-journal.jsonl")
    report = [r for r in rows if r["kind"] == "straggler_report"]
    assert len(report) == 1 and report[0]["num_ranks"] == 2 and "partial" not in report[0], \
        report
    waited = {normalize_tag(e["args"]["tag"]) for t in traces for e in t["traceEvents"]
              if e.get("name") in ("exchange/allgather", "exchange/barrier")}
    named = {r["tag"] for r in report[0]["tags"]}
    assert waited and named == waited, (sorted(named ^ waited))
    return {"files": files, "events": [len(t["traceEvents"]) for t in traces],
            "journal_rows": len(rows), "tags": len(named),
            "stragglers": {r["tag"]: r["straggler_rank"] for r in report[0]["tags"][:5]}}


def _partitioned_rank_main(rank: int, world: int, seed: int, device_type: str,
                           device_index: int, jobs: list) -> None:
    """One rank of phase 13 in a gloo group of ``world`` with CUDA tensors:
    each of ``jobs``, (directory, job) with ``job["what"]`` "paths" for
    (a)-(d) or "drivers" for (e), in turn in the one group, writing its
    report to ``<directory>/rank<r>.json``. A module function, so a spawned
    process runs it."""
    import datetime

    import numpy as np
    import torch

    from photon_ml_torch.parallel import multihost

    try:
        dev = torch.device(device_type, device_index) if device_type == "cuda" \
            else torch.device(device_type)
        multihost.initialize(f"file://{jobs[0][0]}/rendezvous", world, rank,
                             local_rank=device_index, device=dev, backend="gloo",
                             timeout=datetime.timedelta(seconds=PARTITIONED["rank_timeout_s"]))
        for tmp, job in jobs:
            if job["what"] == "paths":
                out = _partitioned_paths(torch, np, rank, world, Path(tmp), dev, job)
            else:
                out = _partitioned_drivers(rank, Path(tmp), job)
            (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out, default=float))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        multihost.shutdown()


def _spawn_partitioned(torch, dev, jobs: list, seed: int, label: str) -> tuple:
    """Two ranks running ``jobs`` ((directory, job) pairs, in turn in one
    process group) on the card (gloo, CUDA tensors; NCCL over two cards
    where there are two), joined within ``rank_timeout_s`` a job: (each
    job's reports, seconds with process start)."""
    two_cards = dev.type == "cuda" and torch.cuda.device_count() >= 2
    for tmp, _ in jobs:
        tmp.mkdir(parents=True, exist_ok=True)
    ctx = _processes()
    procs = [ctx.Process(target=_partitioned_rank_main,
                         args=(r, 2, seed, dev.type, r if two_cards else 0,
                               [(str(tmp), job) for tmp, job in jobs]))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(PARTITIONED["rank_timeout_s"] * len(jobs))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(30)
    assert not alive, f"{label}: {len(alive)} ranks still running"
    assert all(p.exitcode == 0 for p in procs), (label, [p.exitcode for p in procs])
    return ([[json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
             for tmp, _ in jobs], time.perf_counter() - t0)


def _partitioned_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 13, partitioned I/O, printing as it goes. Returns, for each
    kernel this path runs, its launches on rank 0 of the partitioned runs and
    its checks on rank 0's own block."""
    from photon_ml_torch import convert
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver
    from photon_ml_torch.data.game_data import (
        build_random_effect_dataset,
        build_random_effect_dataset_partitioned,
    )
    from photon_ml_torch.io.data_reader import read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model, read_scores
    from photon_ml_torch.io.partitioned_reader import read_partitioned
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh
    from photon_ml_torch.parallel.scoring import DistributedScorer

    summary: dict = {}
    with tempfile.TemporaryDirectory(prefix="partitioned-",
                                     dir=Path(__file__).resolve().parent / "build") as tmp:
        tmp = Path(tmp)
        avro = _flagship_avro(np, seed, tmp)
        sparse = _sparse_avro(np, seed, tmp / "sparse")
        train_files = sorted(Path(avro["train"]).glob("part-*.avro"))
        # two held-out parts (a quarter of the held-out rows): the blocks mode
        # decodes with the Python codec, about 500 records/s a rank
        held_files = sorted(Path(avro["validation"]).glob("part-*.avro"))[:2]
        blocks = _blocks_container(held_files, tmp / "blocks" / "one.avro")
        (tmp / "blocks-files").mkdir()
        for f in held_files:
            os.symlink(f, tmp / "blocks-files" / f.name)
        _log(f"13. inputs: flagship {avro['n']} + {avro['held_out']} rows "
             f"({len(train_files)} training parts clustered by user), sparse {sparse['n']} "
             f"rows written in {sparse['write_seconds']:.2f} s"
             + (" of writer time (its parts' seconds summed; in the background)"
                if sparse["background"] else "")
             + ", one container of "
             f"{blocks['records']} rows in {blocks['blocks']} blocks")

        # a. one NCCL rank: the partitioned path's one-rank read is the full
        # read, and its training the full read's bit for bit
        info = multihost.initialize(device=None if dev.type == "cuda" else dev)
        mesh = make_mesh()
        ex = multihost.default_exchange()
        cfg = _partitioned_cfg("flagship")
        part = read_partitioned(avro["train"], cfg, exchange=ex,
                                random_effect_id_columns=("userId",), device=dev)
        assert part.mode == "single"
        program = _fused_program(k=None, re_types=("userId",), mesh=mesh)
        res = {"userId": build_random_effect_dataset_partitioned(
            part.result.dataset, "userId", "per_entity", partition=part.partition, exchange=ex,
            bucket_sizes=(PARTITIONED["cap"],))}
        one = _partitioned_run(torch, "a. one rank", program, {0: (part.result.dataset, res)},
                               mesh, 1, PARTITIONED["sweeps"], ex)
        ref = dist.train_distributed(program, part.result.dataset, {
            "userId": build_random_effect_dataset(part.result.dataset, "userId", "per_entity",
                                                  bucket_sizes=(PARTITIONED["cap"],))},
            mesh=mesh, num_iterations=PARTITIONED["sweeps"])
        gap, scale, bitwise = _state_gap(
            np, _flat_state(convert.train_state_to_numpy(one.pop("state"))),
            _flat_state(convert.train_state_to_numpy(ref.state)))
        _log(f"13a. one {info.backend} rank ({card}): train_partitioned against the full "
             f"read's train_distributed(mesh=): bitwise {bitwise} (max |dw| {gap:.3g}), losses "
             f"{one['losses']} / {ref.losses}, seconds a sweep {one['seconds_per_sweep']:.4f}, "
             "launches " + json.dumps(one["launches"]))
        assert bitwise and one["losses"] == ref.losses, (gap, one["losses"], ref.losses)
        summary["one_rank"] = {k: one[k] for k in ("seconds_per_sweep", "launches", "losses")}
        del part, res, ref
        torch.cuda.empty_cache()

        # a-d and e on two ranks, one process group for both
        shards = ["--feature-shard-configurations",
                  "name=global,feature.bags=features,intercept=true",
                  "--feature-shard-configurations",
                  "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
        coordinates = ["--coordinate-configurations",
                       "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
                       "--coordinate-configurations",
                       "name=per_user,feature.shard=per_entity,reg.weights=1,optimizer=NEWTON,"
                       "max.iter=10,random.effect.type=userId"]
        device = None if dev.type == "cuda" else dev
        paths_job = {"what": "paths", "train": str(avro["train"]),
                     "validation": str(avro["validation"]), "sparse": str(sparse["path"]),
                     "blocks_file": str(blocks["file"]),
                     "blocks_files": str(tmp / "blocks-files")}
        drivers_job = {"what": "drivers", "train": str(avro["train"]),
                       "validation": str(avro["validation"]), "shards": shards,
                       "coordinates": coordinates, "device": device}
        (ranks, drivers), seconds = _spawn_partitioned(
            torch, dev, [(tmp / "paths", paths_job), (tmp / "drivers", drivers_job)], seed,
            "13a-e")
        r0, r1 = ranks
        for r in ranks:
            for label, read in r["reads"].items():
                _log(f"13. rank {r['rank']} read {label} ({read['mode']} mode; {card}): "
                     f"{read['bytes_decoded']} of {read['input_bytes_total']} bytes "
                     f"({read['bytes_decoded'] / read['input_bytes_total']:.3f}), "
                     f"{read['rows']} rows in {read['seconds']:.2f} s "
                     f"({read['records_per_s']:.0f} records/s)"
                     + (f" against the full read's {read['full_seconds']:.2f} s "
                        f"({read['full_records_per_s']:.0f} records/s)"
                        if "full_seconds" in read else "")
                     + (f"; entities on both ranks {read['spanning']}" if read["spanning"]
                        else ""))
        for label in ("flagship", "sparse ell", "sparse hybrid", "held-out"):
            share = r0["reads"][label]["bytes_decoded"] / r0["reads"][label]["input_bytes_total"]
            assert 0.3 < share < 0.7, (label, share)
        # a. the flagship on two ranks against the full read
        for label in ("user", "user+item"):
            run = r0["runs"][label]
            states = [dict(np.load(tmp / "paths" / f"state-{label}-{r}.npz")) for r in (0, 1)]
            ranks_equal = all(np.array_equal(states[0][k], states[1][k]) for k in states[0])
            _log(f"13a. FE + {label}, two ranks ({card}): state against the full read max "
                 f"|dw| {run['state_gap']:.3g} (max |w| {run['state_scale']:.3g}"
                 + (", limit 1e-3·max|w|" if label == "user" else
                    f", no bound: {r0['reads']['flagship']['spanning']} entities span the "
                    "ranks") + "), training loss rel gap a sweep "
                 + json.dumps([float(f"{g:.3g}") for g in run["loss_gaps"]]) + ", bitwise repeat "
                 f"{run['bitwise_repeat']}, ranks' states equal {ranks_equal}; seconds a sweep "
                 + json.dumps(run["seconds_per_sweep_runs"]) + "; launches "
                 + json.dumps(run["launches"]) + "; collectives " + json.dumps(run["collectives"]))
            assert ranks_equal and run["bitwise_repeat"], label
            if label == "user":
                # the f32 sums over other row blocks move each sweep's L-BFGS
                # solve: the losses meet as the sweeps converge, the final one
                # within 1e-5
                assert r0["reads"]["flagship"]["spanning"].get("userId", 0) == 0
                assert run["state_gap"] <= 1e-3 * run["state_scale"] \
                    and run["loss_gaps"][-1] <= 1e-5, run
        assert r0["reads"]["flagship"]["spanning"].get("itemId", 0) > 0
        # b. the sparse layouts against the full read's, the states within 1e-3
        for kind in ("ell", "hybrid"):
            layout = r0["layouts"][kind]
            run = r0["runs"][f"sparse {kind}"]
            want = layout["full"]
            _log(f"13b. sparse {kind} ({card}): agreed ELL width {layout['ell_width']}, flat "
                 f"block {layout['flat_block_nnz']}, {len(layout['hot_ids'] or [])} hot ids; "
                 f"the full read's {want['ell_width']}, {want['flat_block_nnz']}, "
                 f"{len(want['hot_ids'] or [])}; state against the full read max |dw| "
                 f"{run['state_gap']:.3g} (limit 1e-3·max|w| = {1e-3 * run['state_scale']:.3g}); "
                 f"seconds a sweep {run['seconds_per_sweep']:.4f}; launches "
                 + json.dumps(run["launches"]))
            assert layout["ell_width"] == want["ell_width"] \
                and layout["flat_block_nnz"] == want["flat_block_nnz"] \
                and layout["hot_ids"] == want["hot_ids"], (kind, layout, want)
            assert all(layout[k] == r1["layouts"][kind][k] for k in r1["layouts"][kind]), kind
            assert run["state_gap"] <= 1e-3 * run["state_scale"], (kind, run["state_gap"])
        # c. blocks mode: array for array the files mode's
        rows = {mode: [dict(np.load(tmp / "paths" / f"rows-{mode}-{r}.npz")) for r in (0, 1)]
                for mode in ("blocks", "blocks-as-files")}
        for k in rows["blocks"][0]:
            if k.startswith("vocab/"):
                assert all(np.array_equal(rows["blocks"][r][k], rows["blocks-as-files"][r][k])
                           for r in (0, 1)), k
            else:
                assert np.array_equal(
                    np.concatenate([rows["blocks"][r][k] for r in (0, 1)]),
                    np.concatenate([rows["blocks-as-files"][r][k] for r in (0, 1)])), k
        for r in (0, 1):
            assert (tmp / "paths" / f"maps-blocks-{r}.json").read_text() == \
                (tmp / "paths" / f"maps-blocks-as-files-{r}.json").read_text()
        _log(f"13c. blocks mode ({card}): {blocks['records']} rows read as one container "
             f"({r0['reads']['blocks']['mode']}, Python codec) array for array the files "
             f"mode's ({r0['reads']['blocks as files']['mode']}, native decoder): records/s "
             + json.dumps({lab: [round(r["reads"][lab]["records_per_s"], 1) for r in ranks]
                           for lab in ("blocks", "blocks as files")}))
        assert r0["reads"]["blocks"]["mode"] == "blocks"
        # d. the ranks' score parts against the one-rank scorer's scores
        maps = IndexMap.load_directory(tmp / "paths" / "index-maps")
        model = load_game_model(tmp / "paths" / "model", maps, device=dev)
        vocabs = {m.random_effect_type: m.entity_keys for m in model.models.values()
                  if hasattr(m, "entity_keys")}
        val = read_merged(avro["validation"], cfg, index_maps=maps,
                          random_effect_id_columns=("userId",), entity_vocabs=vocabs,
                          device=dev).dataset
        whole = DistributedScorer(model, mesh).score_dataset(val)
        got = [dict(np.load(tmp / "paths" / f"scores-{r}.npz")) for r in (0, 1)]
        union = np.concatenate([g["scores"] for g in got])
        score_bitwise = bool(np.array_equal(union, whole)) and np.array_equal(
            np.concatenate([g["uids"] for g in got]), val.unique_ids)
        _log(f"13d. score_partitioned of {len(whole)} held-out rows ({card}): the ranks' "
             f"{[len(g['scores']) for g in got]} rows against the one-rank scorer's: bitwise "
             f"{score_bitwise} (max |ds| {float(np.abs(union - whole).max()):.3g}); seconds "
             + json.dumps([r["score_seconds"] for r in ranks]))
        assert score_bitwise
        summary["two_ranks"] = {"seconds": seconds, "reads": {r["rank"]: r["reads"]
                                                             for r in ranks},
                                "runs": {k: {f: v[f] for f in ("seconds_per_sweep", "launches",
                                                               "collectives", "state_gap",
                                                               "state_scale")}
                                         for k, v in r0["runs"].items()},
                                "layouts": r0["layouts"]}
        del model, val, whole

        # e. the drivers at the flagship's (cut) rows: the ranks' runs above
        # against the --distributed run of one process
        t0 = time.perf_counter()
        game_training_driver.main([
            "--input-data-path", str(avro["train"]), "--root-output-dir", str(tmp / "full"),
            "--task-type", "LOGISTIC_REGRESSION", *shards, *coordinates,
            "--coordinate-descent-iterations", "2", "--distributed"], device=device)
        full_s = time.perf_counter() - t0
        out = tmp / "drivers"
        game_scoring_driver.main([
            "--input-data-path", str(avro["validation"]), "--model-input-dir",
            str(out / "part" / "best"), "--output-dir", str(tmp / "scores-one"), *shards,
            "--distributed"], device=device)
        same = {}
        for f in sorted((tmp / "full").rglob("*")):
            rel = f.relative_to(tmp / "full")
            if f.is_file() and ("index-maps" in rel.parts or f.name in ("id-info",
                                                                        "model-metadata.json")):
                same[str(rel)] = (out / "part" / rel).read_bytes() == f.read_bytes()
        assert same and all(same.values()), same
        maps = IndexMap.load_directory(tmp / "full" / "index-maps")
        a, b = (load_game_model(d / "best", maps, device=dev) for d in (tmp / "full",
                                                                      out / "part"))
        gaps = {}
        for cid, m in a.models.items():
            x = m.glm.coefficients.means if hasattr(m, "glm") else m.coefficients
            other = b.get(cid)
            y = other.glm.coefficients.means if hasattr(other, "glm") else other.coefficients
            gaps[cid] = (float((y.double() - x.double()).abs().max()),
                         float(x.double().abs().max()))
        parts = sorted(os.listdir(tmp / "drivers" / "scores-part" / "scores"))
        got = [r for p in parts for r in read_scores(tmp / "drivers" / "scores-part" / "scores"
                                                     / p)]
        want = list(read_scores(tmp / "scores-one" / "scores"))
        _log(f"13e. the GAME drivers with --partitioned-io --distributed on two ranks at "
             f"{avro['n']} + {avro['held_out']} rows ({card}): {len(same)} files without "
             f"coefficients byte-identical to the --distributed run's, coefficient gaps "
             + json.dumps(gaps) + f", score parts {parts} hold the one-rank scores exactly "
             f"{got == want}; seconds: --distributed training {full_s:.2f}, partitioned "
             + json.dumps({r["rank"]: {"train": round(r["train_seconds"], 2),
                                       "score": round(r["score_seconds"], 2),
                                       "read": round(r["timings"].get("read training data", 0),
                                                     2)} for r in drivers})
             + f"; the two ranks' jobs (a)-(e) {seconds:.2f} s with process start")
        assert all(g <= 1e-3 * s for g, s in gaps.values()), gaps
        assert parts == ["part-00000.avro", "part-00001.avro"] and got == want
        _SHARED["partitioned_traces"] = _rank_traces(out)
        summary["drivers"] = {"coefficient_gaps": gaps, "byte_identical": len(same),
                              "seconds": seconds, "full_training_seconds": full_s}
    multihost.shutdown()
    launches = r0["runs"]["user"]["launches"]
    sparse_launches = [r0["runs"][f"sparse {k}"]["launches"] for k in ("ell", "hybrid")]
    checks = r0["checks"]
    path = {"fused_glm": dict(checks["b1"]["fused_glm"], launches=launches["fused_glm"]),
            "fused_glm_reduce": dict(checks["b1"]["fused_glm_reduce"],
                                     launches=launches["fused_glm_reduce"]),
            "sparse_gather": {"launches": sum(x["rows"] + x["segments"] for x in sparse_launches),
                              "row_kernel": sum(x["rows"] for x in sparse_launches),
                              "segment_kernel": sum(x["segments"] for x in sparse_launches),
                              "checks": checks["gather"]},
            "sparse_gather_chunks": {"launches": sum(x["chunks"] for x in sparse_launches),
                                     "checks": [c for c in checks["gather"] if c["chunk_rows"]]}}
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    path["fused_glm"]["summary"] = summary
    return path


#: phase 14, the model axis (ROADMAP item 15): phase 5's ELL (L-BFGS at λ=1,
#: then TRON) and its hybrid d=10^8 TRON solve column-sharded over model=2,
#: phase 11's flagship and phase 9's sparse GAME shape with the fixed effect
#: feature-sharded at 1x2 and 2x2, feature-sharded scoring of the 2^15
#: held-out rows, and both GAME drivers with --mesh data=1,model=2 on the
#: flagship's cut Avro (phase 12(d)'s); none of the widths cut. The ELL solves run fixed
#: budgets: run to their stopping tests, f32 solves of this flat optimum end
#: at the objective's resolution (L-BFGS at a failed line search after 42-71
#: iterations, TRON's gradient test met after 8 iterations on one device and
#: not within 15 on two ranks), 1.9e-3·max|w| apart, so only a budget short
#: of that floor holds the two paths to 1e-3·max|w| (PERF.md §6, ROADMAP C)
MODEL_AXIS = dict(rank_timeout_s=600, ell_lbfgs=dict(max_iterations=20),
                  ell_tron=dict(max_iterations=5, tolerance=1e-5, max_cg_iterations=20),
                  hybrid_tron=dict(max_iterations=3, max_cg_iterations=2), sweeps=4,
                  sparse_sweeps=2, state_limit=1e-3, loss_limit=1e-5, score_limit=1e-5)

#: the TPU function whose G1 rows, chunks and segments the model axis calls
G1_REPLACES = "experiments/sparse_gather_probe.py:70"


def _block_rows_entry(torch, tag: str, w, n: int, check: dict, tail, chunks) -> dict:
    """G1's row kernel over a column block's row-sorted entries (the
    partial margins of one rank's columns): device, eager and plain times,
    cuSPARSE's CSR product of the same entries (``library_ms``), and the
    bound from each entry, the row pointers, the output and each distinct
    column of ``w`` once at 2 f32 operations an entry."""
    from photon_ml_torch.ops import sparse_gather

    vals, cols, _, row_ptr = tail
    stored = vals.numel()
    nbytes = stored * (vals.element_size() + 4) + 4 * n + 4 * (n + 1) \
        + 4 * int(torch.unique(cols).numel()) + (0 if chunks is None else chunks.nbytes())
    bound, by = _bound_ms(nbytes, 2.0 * stored)
    csr = torch.sparse_csr_tensor(row_ptr, cols, vals.float(), (n, w.shape[0]),
                                  check_invariants=False)

    def kernel():
        return sparse_gather.gather_sum(w, n, tail=tail, chunks=chunks)

    return {"case": tag, "max_abs_err": check["max_abs_err"],
            "worst_err_share_of_limit": check["max_err_over_scale"] / check["rel_limit"],
            "ms": _device_ms(torch, kernel), "eager_ms": _eager_ms(torch, kernel),
            "plain_ms": _device_ms(torch, lambda: sparse_gather.gather_sum_reference(
                w, n, tail=tail)),
            "bound_ms": bound, "bound_by": by, "library_ms": _device_ms(torch, lambda: csr @ w),
            "shape": [n, stored], "d": int(w.shape[0]), "bytes": nbytes,
            "chunks": None if chunks is None else chunks.count}


def _column_block_checks(torch, tag: str, batch, w, n: int) -> dict:
    """G1 on one rank's column block at its solved coefficients ``w``: the
    partial margins (row kernel, long rows' chunks) and the transpose over
    the block's column-sorted entries (segment kernel, long columns'
    chunks), each held against its plain version (:func:`_gather_check`,
    per row 1e-5·Σ|v·w| in f64, twice bitwise), with times and bounds."""
    row_ptr, row_chunks, col_chunks, nnz = batch.plans()
    w = w.float().contiguous()
    tail = (batch.values[0], batch.local_cols[0], batch.row_ids[0], row_ptr)
    margins = _gather_check(torch, f"{tag}: partial margins", w, n, tail=tail, chunks=row_chunks)
    gen = torch.Generator(device=w.device).manual_seed(n)
    r = torch.rand(n, device=w.device, generator=gen)
    plan = (batch.vals_by_col[0, :nnz], batch.rows_by_col[0, :nnz], batch.local_bounds[0],
            col_chunks)
    t_tail = (plan[0], plan[1], None, plan[2])
    transpose = _gather_check(torch, f"{tag}: own-column transpose", r, batch.block,
                              tail=t_tail, chunks=col_chunks)
    out = {"rows": _block_rows_entry(torch, f"{tag}: partial margins", w, n, margins, tail,
                                     row_chunks),
           "segments": _transpose_entry(torch, G1_REPLACES, r, batch.block, transpose, plan,
                                        f"{tag} column block")}
    out["segments"]["case"] = f"{tag}: own-column transpose"
    if col_chunks is not None:
        out["chunks"] = _chunk_entry(torch, G1_REPLACES, r, t_tail, col_chunks,
                                     f"{tag}: the block's long columns")
    return out


def _model_axis_sparse_glm(torch, np, rank: int, world: int, tmp: Path, dev, seed: int,
                           job: dict) -> dict:
    """Phase 14(b) on one rank: phase 5's ELL (L-BFGS at λ=1, then TRON) and
    hybrid d=10^8 TRON with the coefficient axis over a 1 x ``world`` mesh,
    each solve twice; writes the rank's solved block to
    ``tmp/<case>-<solver>-<rank>.npy``."""
    from photon_ml_torch.data.sparse_batch import HybridPolicy, SparseShard
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.optim import lbfgs as tlbfgs
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType, solve
    from photon_ml_torch.parallel import column_sharded as cs
    from photon_ml_torch.parallel import mesh as mesh_ops
    from photon_ml_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=world)
    k = mesh_ops.model_rank(mesh)
    out = {"rank": rank, "model_rank": k, "device": str(dev), "cases": {}}
    lbfgs = OptimizerConfig(OptimizerType.LBFGS, **MODEL_AXIS["ell_lbfgs"])
    cases = {"ell": ([("lbfgs", lbfgs, 1.0),
                      ("tron", OptimizerConfig(OptimizerType.TRON, **MODEL_AXIS["ell_tron"]), 1.0)],
                     None),
             "hybrid_1e8": ([("tron", OptimizerConfig(OptimizerType.TRON,
                                                      **MODEL_AXIS["hybrid_tron"]), 0.1)],
                            HybridPolicy(hot_cols=SPARSE["hybrid_1e8"]["hot_cols"]))}
    for name, (solvers, policy) in cases.items():
        cfg = SPARSE[name]
        t0 = time.perf_counter()
        if name == "ell":
            (rows, cols, vals, y), _ = _planted_ell_data(np, seed, cfg["n"], cfg["d"],
                                                         cfg["per_row"], cfg["held_out"])
        else:
            rows, cols, vals, y = _zipf_data(np, seed + 5, cfg["n"], cfg["d"], cfg["per_row"])
        shard = SparseShard(rows=rows, cols=cols, vals=vals, num_samples=cfg["n"],
                            feature_dim=cfg["d"], hybrid_policy=policy)
        batch = cs.shard_column_batch(cs.build_column_sharded_batch(
            shard, y, mesh_ops.model_size(mesh), only_block=k, device=dev), mesh)
        del rows, cols, vals, shard
        batch.plans()
        torch.cuda.synchronize()
        case = {"build_seconds": time.perf_counter() - t0, "block": batch.block,
                "entries": int(batch.values.shape[1]),
                "hot_head": None if batch.hot_vals is None else list(batch.hot_vals.shape)}
        for label, opt, lam in solvers:
            obj = cs.ColumnShardedGLMObjective(LogisticLoss(), mesh, l2_weight=lam)
            evaluations = {"value_and_gradient": 0, "hessian_vector": 0}
            for fn in evaluations:
                def counted(*a, _fn=getattr(obj, fn), _k=fn, **kw):
                    evaluations[_k] += 1
                    return _fn(*a, **kw)
                setattr(obj, fn, counted)
            shapes = []
            update = tlbfgs.update_history

            def spy(s_hist, y_hist, *args):
                shapes.append([list(s_hist.shape), s_hist.element_size()])
                return update(s_hist, y_hist, *args)

            runs = []
            tlbfgs.update_history = spy
            try:
                for _ in range(2):
                    for key in evaluations:
                        evaluations[key] = 0
                    _reset_gather_counts()
                    mesh_ops.counts.reset()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = solve(opt, obj.bind(batch),
                                cs.init_column_sharded_coefficients(batch, mesh))
                    torch.cuda.synchronize()
                    runs.append({"seconds": time.perf_counter() - t0, "result": res,
                                 "evaluations": dict(evaluations), "launches": _gather_counts(),
                                 "collectives": mesh_ops.counts.by_axis()})
            finally:
                tlbfgs.update_history = update
            a, b = (r.pop("result") for r in runs)
            hist = a.value_history[: a.iterations + 1].double().cpu().numpy()
            bitwise = bool(a.iterations == b.iterations
                           and torch.equal(a.coefficients, b.coefficients)
                           and torch.equal(a.value_history[: a.iterations + 1],
                                           b.value_history[: b.iterations + 1]))
            np.save(tmp / f"{name}-{label}-{rank}.npy", a.coefficients.cpu().numpy())
            grad = obj.value_and_gradient(a.coefficients, batch)[1]
            case[label] = {
                "lambda": lam, "iterations": a.iterations, "reason": a.reason,
                "value": float(a.value), "values": hist.tolist(), "bitwise_repeat": bitwise,
                "runs": runs, "coefficient_bytes": a.coefficients.numel()
                * a.coefficients.element_size(),
                "gradient_bytes": grad.numel() * grad.element_size(),
                "history_bytes": sum(2 * s[0][0] * s[0][1] * s[1] for s in shapes[:1]),
                "history_shape": shapes[0][0] if shapes else None}
            if rank == 0 and label == solvers[-1][0]:
                case["checks"] = _column_block_checks(torch, f"b. {name} block {k} of {world}",
                                                      batch, a.coefficients, cfg["n"])
            del a, b, grad
        out["cases"][name] = case
        del batch
        torch.cuda.empty_cache()
    return out


def _model_axis_run(torch, label: str, program, dataset, re_datasets, mf_datasets,
                    sweeps: int, mesh) -> dict:
    """``train_distributed(fe_feature_sharded=True)`` over ``mesh`` with the
    gather counters and the collectives set to 0 just before and read just
    after: per sweep its seconds, loss and collectives by axis, and every
    FE solve's per-iteration values, iterations and reason."""
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import mesh as mesh_ops

    fe_solves = []
    solve = dist.solve

    def recorded(config, objective, w0, **kw):
        res = solve(config, objective, w0, **kw)
        if config is program.fe.optimizer:
            fe_solves.append({"values": res.value_history[: res.iterations + 1].double()
                              .cpu().numpy().tolist(), "iterations": res.iterations,
                              "reason": res.reason, "length": int(w0.shape[0])})
        return res

    marks = []

    def on_sweep(done, total, loss):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), loss, mesh_ops.counts.by_axis()))

    _reset_gather_counts()
    mesh_ops.counts.reset()
    dist.solve = recorded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = dist.train_distributed(program, dataset, re_datasets, mf_datasets=mf_datasets,
                                        num_iterations=sweeps, mesh=mesh,
                                        fe_feature_sharded=True, on_sweep=on_sweep)
    finally:
        dist.solve = solve
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _gather_counts()
    rows, last = [], (t0, {})
    for t, loss, coll in marks:
        rows.append({"seconds": t - last[0], "loss": loss, "collectives": {
            axis: {op: {f: v[f] - last[1].get(axis, {}).get(op, {}).get(f, 0)
                        for f in ("calls", "bytes")} for op, v in ops.items()}
            for axis, ops in coll.items()}})
        last = (t, coll)
    losses = result.losses
    assert len(losses) == sweeps and all(math.isfinite(v) for v in losses), (label, losses)
    return {"run": label, "seconds": seconds, "seconds_per_sweep": seconds / sweeps,
            "sweeps": rows, "losses": losses, "launches": launches, "fe_solves": fe_solves,
            "result": result}


def _model_axis_fused(torch, np, rank: int, world: int, tmp: Path, dev, seed: int,
                      job: dict) -> dict:
    """Phase 14(c) and (d) on one rank of a ``job["shape"]`` mesh: phase
    11's flagship with the fixed effect feature-sharded (one warm-up sweep,
    then twice 4 sweeps), one profiled sweep, feature-sharded scoring of
    the held-out rows against the one-device transform, and phase 9's
    sparse GAME shape with the fixed effect feature-sharded; writes the
    whole state of the first run to ``tmp/state<rank>.npz``."""
    from photon_ml_torch import convert
    from photon_ml_torch.data.game_data import build_game_dataset, build_random_effect_dataset
    from photon_ml_torch.data.sparse_batch import SparseShard
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import mesh as mesh_ops
    from photon_ml_torch.parallel.mesh import make_mesh
    from photon_ml_torch.parallel.scoring import DistributedScorer
    from photon_ml_torch.transformers import GameTransformer

    data_axis, model_axis = job["shape"]
    mesh = make_mesh(data=data_axis, model=model_axis)
    tag = f"c. {data_axis}x{model_axis} rank {rank}"
    ds, held_ds, re_ds, mf_ds = _mesh_flagship(np, seed, dev)
    program = _fused_program(k=MESH["k"], alternations=MESH["alternations"],
                             mf_l2=MESH["mf_l2"], mesh=mesh, fe_feature_sharded=True)
    _model_axis_run(torch, f"{tag} warm-up", program, ds, re_ds, mf_ds, 1, mesh)
    runs = [_model_axis_run(torch, f"{tag} run {i}", program, ds, re_ds, mf_ds,
                            MODEL_AXIS["sweeps"], mesh) for i in (1, 2)]
    results = [r.pop("result") for r in runs]
    block = results[0].state
    wholes = [_flat_state(convert.train_state_to_numpy(program.whole_state(r.state)))
              for r in results]
    bitwise = all(np.array_equal(wholes[0][key], wholes[1][key]) for key in wholes[0])
    out = {"rank": rank, "data_rank": mesh_ops.data_rank(mesh),
           "model_rank": mesh_ops.model_rank(mesh), "bitwise_repeat": bitwise, "runs": runs,
           "fe_block": [int(block.fe_coefficients.shape[0]), list(block.fe_columns)]}
    np.savez(tmp / f"state{rank}.npz", **wholes[0])
    # one sweep profiled on every rank (each sweep is collective)
    data, buckets = program.prepare_inputs(ds, re_ds, mf_ds)
    data, buckets, state = program.shard_inputs(mesh, data, buckets, block,
                                                fe_feature_sharded=True)
    out["profiled_sweep"] = _profiled(torch, lambda: program.step(data, buckets, state))
    del data, buckets
    # d. scoring the held-out rows with the fixed effect feature-sharded
    model = dist.state_to_game_model(program, block, ds, re_datasets=re_ds)
    on_mesh = DistributedScorer(model, mesh, fe_feature_sharded=True).score_dataset(held_ds)
    one = GameTransformer(model).transform(held_ds).scores
    out["scoring"] = {"rows": int(held_ds.num_samples),
                      "rel_gap": float(np.abs(on_mesh - one).max() / np.abs(one).max())}
    del program, results, block, state, model, ds, held_ds, re_ds, mf_ds
    torch.cuda.empty_cache()
    if job.get("sparse"):
        # phase 9's sparse GAME shape (phase 11(b)'s program) with its fixed
        # effect feature-sharded: G1 on the rank's column block
        cfg = FUSED["sparse"]
        part, _ = _sparse_game_arrays(np, seed, cfg["n"], cfg["d"], cfg["per_row"],
                                      cfg["users"])
        shard = SparseShard(rows=part["rows"].astype(np.int64),
                            cols=part["cols"].astype(np.int64), vals=part["vals"],
                            num_samples=part["n"], feature_dim=cfg["d"])
        sds = build_game_dataset(labels=part["labels"], feature_shards={"global": shard},
                                 entity_keys={"user": part["users"]}, device=dev)
        del part
        prog = _fused_program(k=None, re_types=("user",), re_shard="global",
                              projector="INDEX_MAP", task="LINEAR_REGRESSION", mesh=mesh,
                              fe_feature_sharded=True)
        res = {"user": build_random_effect_dataset(sds, "user", "global")}
        run = _model_axis_run(torch, f"{tag} sparse GAME", prog, sds, res, None,
                              MODEL_AXIS["sparse_sweeps"], mesh)
        sstate = run.pop("result").state
        out["sparse"] = run
        if rank == 0:
            data, buckets = prog.prepare_inputs(sds, res)
            data, _, sstate = prog.shard_inputs(mesh, data, buckets, sstate,
                                                fe_feature_sharded=True)
            cb = data["fe_column_batch"]
            out["sparse_checks"] = _column_block_checks(
                torch, f"c. sparse GAME block {mesh_ops.model_rank(mesh)}", cb,
                sstate.fe_coefficients, cb.num_samples)
            out["compact_checks"] = [_compact_check(
                torch, f"{tag} sparse GAME: compact scores", data["re_sparse"]["user"],
                sstate.re_tables["user"].float().contiguous())]
        del prog, res, sds, shard, sstate
        torch.cuda.empty_cache()
    return out


def _model_axis_drivers(torch, np, rank: int, world: int, tmp: Path, dev, seed: int,
                        job: dict) -> dict:
    """Phase 14(e) on one rank: phase 12(d)'s training and scoring driver
    runs with ``--mesh data=1,model=<world>`` (rank 0 writes into
    ``job["out"]``), then the saved model scored in this process over the
    same mesh with the fixed effect feature-sharded."""
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model, read_scores
    from photon_ml_torch.parallel.mesh import make_mesh
    from photon_ml_torch.transformers import GameTransformer

    out_dir = Path(job["out"])
    mesh_flag = ["--mesh", f"data=1,model={world}"]
    device = None if dev.type == "cuda" else dev
    t0 = time.perf_counter()
    summary = game_training_driver.main(
        job["train_args"] + ["--root-output-dir", str(out_dir / "train")] + mesh_flag,
        device=device)
    torch.cuda.synchronize()
    seconds = {"train": time.perf_counter() - t0}
    t0 = time.perf_counter()
    game_scoring_driver.main(job["score_args"] + [
        "--model-input-dir", str(out_dir / "train" / "best"),
        "--output-dir", str(out_dir / "scores")] + mesh_flag, device=device)
    torch.cuda.synchronize()
    seconds["score"] = time.perf_counter() - t0
    maps = IndexMap.load_directory(out_dir / "train" / "index-maps")
    model = load_game_model(out_dir / "train" / "best", maps, device=dev)
    cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
           "per_entity": FeatureShardConfiguration(feature_bags=("perEntityFeatures",),
                                                   has_intercept=False)}
    val = read_merged(job["validation"], cfg, index_maps=maps,
                      random_effect_id_columns=("itemId", "userId"),
                      entity_vocabs={m.random_effect_type: m.entity_keys
                                     for m in model.models.values()
                                     if hasattr(m, "entity_keys")}, device=dev).dataset
    mesh = make_mesh(data=1, model=world)
    in_process = GameTransformer(model, mesh=mesh, fe_feature_sharded=True).transform(val).scores
    out = {"rank": rank, "seconds": seconds, "distributed": summary["distributed"]}
    if rank == 0:
        got = np.asarray([r["predictionScore"] for r in read_scores(out_dir / "scores" / "scores")])
        out["written_scores_bitwise"] = bool(np.array_equal(got.astype(in_process.dtype),
                                                            in_process))
        out["rows"] = int(len(got))
    return out


def _model_axis_rank_main(rank: int, world: int, seed: int, device_type: str,
                          device_index: int, backend: str, jobs: list) -> None:
    """One rank of phase 14: each of ``jobs``, (directory, job) with
    ``job["what"]`` "sparse_glm" for (b), "fused" for (c) and (d) or
    "drivers" for (e), in turn in one process group, writing its report to
    ``<directory>/rank<r>.json``. A module function, so a spawned process
    runs it."""
    import datetime

    import numpy as np
    import torch

    from photon_ml_torch.parallel import multihost

    try:
        dev = torch.device(device_type, device_index) if device_type == "cuda" \
            else torch.device(device_type)
        multihost.initialize(f"file://{jobs[0][0]}/rendezvous", world, rank,
                             local_rank=device_index, device=dev, backend=backend,
                             timeout=datetime.timedelta(seconds=MODEL_AXIS["rank_timeout_s"]))
        for tmp, job in jobs:
            fn = {"sparse_glm": _model_axis_sparse_glm, "fused": _model_axis_fused,
                  "drivers": _model_axis_drivers}[job["what"]]
            out = fn(torch, np, rank, world, Path(tmp), dev, seed, job)
            (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out, default=float))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        multihost.shutdown()


def _spawn_model_axis(torch, dev, jobs: list, seed: int, world: int, label: str) -> tuple:
    """``world`` ranks running ``jobs`` ((directory, job) pairs, in turn in
    one process group): NCCL with a card a rank where there are as many
    cards, else gloo with CUDA tensors, every rank on card 0 (NCCL refuses
    two ranks on one device); joined within ``rank_timeout_s`` a job.
    Returns (each job's reports in rank order, backend, seconds with process
    start)."""
    cards = dev.type == "cuda" and torch.cuda.device_count() >= world
    backend = "nccl" if cards else "gloo"
    for tmp, _ in jobs:
        tmp.mkdir(parents=True, exist_ok=True)
    ctx = _processes()
    procs = [ctx.Process(target=_model_axis_rank_main,
                         args=(r, world, seed, dev.type, r if cards else 0, backend,
                               [(str(tmp), job) for tmp, job in jobs]))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(MODEL_AXIS["rank_timeout_s"] * len(jobs))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(30)
    assert not alive, f"{label}: {len(alive)} ranks still running"
    assert all(p.exitcode == 0 for p in procs), (label, [p.exitcode for p in procs])
    return ([[json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
             for tmp, _ in jobs], backend, time.perf_counter() - t0)


def _model_axis_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 14, the model axis, printing as it goes. Returns, for each
    kernel this path runs, its launches here and its checks on the path's
    own inputs (rank 0's column blocks)."""
    from photon_ml_torch import convert
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh

    path: dict = {}
    summary: dict = {}
    base = Path(tempfile.mkdtemp(prefix="model-axis-", dir=_SHARED.get(
        "dir", Path(__file__).resolve().parent / "build")))

    # a. a one-rank NCCL mesh data=1, model=1 through the model-axis code:
    # one column block, so the solvers' reductions are the plain ones and
    # the run is phase 12(a)'s bit for bit
    t0 = time.perf_counter()
    info = multihost.initialize(device=None if dev.type == "cuda" else dev)
    mesh = make_mesh(data=1, model=1)
    ds, _, re_ds, mf_ds = _mesh_flagship(np, seed, dev)
    program = _fused_program(k=MESH["k"], alternations=MESH["alternations"],
                             mf_l2=MESH["mf_l2"], mesh=mesh, fe_feature_sharded=True)
    _fused_run(torch, "14a. warm-up", program, ds, re_ds, mf_ds, 1, mesh=mesh)
    one = _fused_run(torch, "14a. one rank, data=1, model=1, fe_feature_sharded", program, ds,
                     re_ds, mf_ds, MESH["sweeps"], mesh=mesh)
    flat = _flat_state(convert.train_state_to_numpy(one.pop("result").state))
    ref = _SHARED["mesh_flagship"]
    gap, scale, bitwise = _state_gap(np, flat, ref["flat"])
    _log(f"14a. one {info.backend} rank, mesh data=1 model=1 with fe_feature_sharded against "
         f"phase 12(a) ({card}): bitwise {bitwise} (max |dw| {gap:.3g}), losses equal "
         f"{one['losses'] == ref['losses']}; seconds a sweep {one['seconds_per_sweep']:.4f}; "
         f"{time.perf_counter() - t0:.2f} s")
    assert bitwise and one["losses"] == ref["losses"], (gap, one["losses"], ref["losses"])
    path["fused_glm"] = {"launches": one["launches"]["fused_glm"],
                         "evaluations": one["fe_evaluations"]}
    path["fused_glm_reduce"] = {"launches": one["launches"]["fused_glm_reduce"]}
    summary["a"] = {"bitwise_phase_12a": bitwise, "seconds_per_sweep": one["seconds_per_sweep"]}
    del program, ds, re_ds, mf_ds
    multihost.shutdown()
    torch.cuda.empty_cache()

    # b., c. at 1x2 and e. on two ranks, one process group for the three
    drivers = _SHARED["mesh_drivers"]
    avro = _flagship_avro(np, seed, base)
    shards = ["--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
              "--feature-shard-configurations",
              "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
    re_spec = "feature.shard=per_entity,reg.weights=1,optimizer=NEWTON,max.iter=10," \
              "random.effect.type="
    drivers_job = {
        "what": "drivers", "out": str(base / "e-out"), "validation": str(avro["validation"]),
        "train_args": ["--input-data-path", str(avro["train"]), "--task-type",
                       "LOGISTIC_REGRESSION", *shards, "--coordinate-configurations",
                       "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
                       "--coordinate-configurations", f"name=per_user,{re_spec}userId",
                       "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
                       "--coordinate-descent-iterations", "2"],
        "score_args": ["--input-data-path", str(avro["validation"]), *shards,
                       "--evaluators", "AUC"]}
    (ranks, ranks_c2, ranks_e), backend, seconds = _spawn_model_axis(
        torch, dev, [(base / "b", {"what": "sparse_glm"}),
                     (base / "c2", {"what": "fused", "shape": (1, 2), "sparse": True}),
                     (base / "e", drivers_job)], seed, 2, "14b, 14c 1x2, 14e")
    backend_two = backend

    # b. the column-sharded sparse GLM at model=2 against phase 5's one-device solves
    held = []
    for name, label, ref_key in (("ell", "lbfgs", "ell_lbfgs"), ("ell", "tron", "ell_tron"),
                                 ("hybrid_1e8", "tron", "hybrid_1e8_tron")):
        one_device = _SHARED[ref_key]
        w_ref = one_device["w"]
        d = len(w_ref)
        whole = np.concatenate([np.load(base / "b" / f"{name}-{label}-{r['rank']}.npy")
                                for r in sorted(ranks, key=lambda r: r["model_rank"])])
        pad = whole[d:]
        gap = float(np.abs(whole[:d].astype(np.float64) - w_ref).max())
        wscale = float(np.abs(w_ref).max())
        per_rank = [r["cases"][name][label] for r in ranks]
        same = all(p["values"] == per_rank[0]["values"]
                   and p["reason"] == per_rank[0]["reason"] for p in per_rank)
        repeat = all(p["bitwise_repeat"] for p in per_rank)
        run0 = per_rank[0]["runs"][0]
        _log(f"14b. {name} {label} over model=2 ({backend}, {card}): "
             f"{per_rank[0]['iterations']} iterations, reason {per_rank[0]['reason']}, value "
             f"{per_rank[0]['value']:.8g}; "
             f"phase 5's one-device solve: {one_device['solve']}; max |dw| {gap:.3g} against "
             f"it (limit 1e-3·max|w| = {1e-3 * wscale:.3g}); padding lanes max "
             f"{float(np.abs(pad).max()) if len(pad) else 0.0}; ranks' values equal {same}, two "
             f"runs bitwise {repeat}; seconds a solve "
             + json.dumps([[run["seconds"] for run in p["runs"]] for p in per_rank])
             + "; evaluations " + json.dumps(run0["evaluations"]) + "; per rank bytes: "
             "coefficients, gradient, L-BFGS history " + json.dumps(
                 [[p["coefficient_bytes"], p["gradient_bytes"], p["history_bytes"]]
                  for p in per_rank]) + "; collectives (rank 0) "
             + json.dumps(run0["collectives"]) + "; launches (rank 0) "
             + json.dumps(run0["launches"]))
        held.append((name, label, gap <= 1e-3 * wscale, same, repeat,
                     not len(pad) or not np.any(pad)))
        summary.setdefault("b", {})[f"{name}/{label}"] = {
            "gap": gap, "iterations": per_rank[0]["iterations"],
            "reason": per_rank[0]["reason"],
            "seconds": [run["seconds"] for run in per_rank[0]["runs"]],
            "evaluations": run0["evaluations"], "collectives": run0["collectives"],
            "bytes": [[p["coefficient_bytes"], p["gradient_bytes"], p["history_bytes"]]
                      for p in per_rank]}
    _log(f"14b. column-sharded sparse GLM (b, c at 1x2 and e on the two ranks: {seconds:.2f} s "
         f"with process start); build seconds "
         + json.dumps({n: [r["cases"][n]["build_seconds"] for r in ranks]
                       for n in ranks[0]["cases"]}))
    # (case, solver, within 1e-3·max|w|, ranks' values equal, two runs
    # bitwise, padding lanes 0)
    assert all(all(h[2:]) for h in held), held
    launches_b = {"rows": 0, "segments": 0, "chunks": 0}
    for name, case in ranks[0]["cases"].items():
        for label in ("lbfgs", "tron"):
            if label in case:
                for k in launches_b:
                    launches_b[k] += case[label]["runs"][0]["launches"][k]
    checks_b = [case["checks"] for case in ranks[0]["cases"].values() if "checks" in case]

    # c. and d. the fused program with the fixed effect feature-sharded at
    # 1x2 and 2x2 (gloo ranks on the one card), and feature-sharded scoring
    launches_c = {"rows": 0, "segments": 0, "chunks": 0, "compact": 0}
    checks_c, compact_checks = [], []
    for shape in ((1, 2), (2, 2)):
        world = shape[0] * shape[1]
        label = f"14c. {shape[0]}x{shape[1]}"
        if shape == (1, 2):  # run beside (b) and (e)
            ranks, backend, spawned = ranks_c2, backend_two, "run beside (b) and (e)"
        else:
            (ranks,), backend, seconds = _spawn_model_axis(
                torch, dev, [(base / f"c{world}", {"what": "fused", "shape": shape})], seed,
                world, label)
            spawned = f"{seconds:.2f} s with process start"
        states = [dict(np.load(base / f"c{world}" / f"state{r}.npz")) for r in range(world)]
        ranks_equal = all(np.array_equal(states[0][k], s[k]) for s in states[1:]
                          for k in states[0])
        steps_equal = all(r["runs"][0]["fe_solves"] == ranks[0]["runs"][0]["fe_solves"]
                          and r["runs"][0]["losses"] == ranks[0]["runs"][0]["losses"]
                          for r in ranks)
        repeat = all(r["bitwise_repeat"] for r in ranks)
        gap, wscale, _ = _state_gap(np, states[0], ref["flat_ref"])
        # f32 sums in another order move each sweep's solves a little; as for
        # phase 13's ranks, the final loss is held (every sweep's gap printed)
        sweep_gaps = [_rel_gap(a, b) for a, b in zip(ranks[0]["runs"][0]["losses"],
                                                     ref["losses_ref"])]
        loss_gap = sweep_gaps[-1]
        score_gap = max(r["scoring"]["rel_gap"] for r in ranks)
        r0 = ranks[0]
        limits = (MODEL_AXIS["state_limit"], MODEL_AXIS["loss_limit"], MODEL_AXIS["score_limit"])
        _log(f"{label} fused flagship, FE feature-sharded ({backend} ranks on "
             f"{'their own cards' if backend == 'nccl' else 'the one card'}, {card}): state "
             f"against mesh=None max |dw| {gap:.3g} (limit {limits[0]:g}·max|w| = "
             f"{limits[0] * wscale:.3g}), final loss rel gap {loss_gap:.3g} (limit "
             f"{limits[1]:g}; by sweep {json.dumps(sweep_gaps)}), two runs bitwise {repeat}, "
             f"ranks' "
             f"states equal {ranks_equal}, every rank's per-step values equal {steps_equal}; "
             f"FE block per rank {r0['fe_block']}; seconds a sweep "
             + json.dumps([[run["seconds_per_sweep"] for run in r["runs"]] for r in ranks])
             + f"; {spawned}; collectives a sweep by axis (rank 0) "
             + json.dumps(r0["runs"][0]["sweeps"][-1]["collectives"])
             + "; profiled sweep (rank 0) " + json.dumps(r0["profiled_sweep"])
             + f"; d. feature-sharded scoring of {r0['scoring']['rows']} held-out rows: max rel "
             f"gap to the one-device transform {score_gap:.3g} (limit {limits[2]:g})")
        assert gap <= limits[0] * wscale and loss_gap <= limits[1], (label, gap, loss_gap)
        assert repeat and ranks_equal and steps_equal, (label, repeat, ranks_equal, steps_equal)
        assert score_gap <= limits[2], (label, score_gap)
        summary.setdefault("c", {})[f"{shape[0]}x{shape[1]}"] = {
            "state_gap": gap, "loss_gap": loss_gap, "sweep_loss_gaps": sweep_gaps,
            "backend": backend,
            "seconds_per_sweep": [run["seconds_per_sweep"] for run in r0["runs"]],
            "collectives_per_sweep": r0["runs"][0]["sweeps"][-1]["collectives"],
            "profiled_sweep": r0["profiled_sweep"], "score_gap": score_gap}
        for k in ("rows", "segments", "chunks"):
            launches_c[k] += r0["runs"][0]["launches"][k]
        if "sparse" in r0:
            sp = r0["sparse"]
            _log(f"{label} phase 9's sparse GAME shape, FE feature-sharded ({card}): losses "
                 f"{sp['losses']}, seconds a sweep {sp['seconds_per_sweep']:.4f}, launches "
                 + json.dumps(sp["launches"]) + ", collectives a sweep "
                 + json.dumps(sp["sweeps"][-1]["collectives"]))
            for k in launches_c:
                launches_c[k] += sp["launches"][k]
            checks_c.append(r0["sparse_checks"])
            compact_checks += r0["compact_checks"]

    # e. both GAME drivers with --mesh data=1,model=2 against phase 12(d)'s --distributed
    ranks = ranks_e
    out = base / "e-out" / "train"
    same = {}
    for sub in ("index-maps", "best"):
        for f in sorted((drivers / "distributed" / sub).rglob("*")):
            rel = f.relative_to(drivers / "distributed")
            if f.is_file() and (sub == "index-maps" or f.name in ("id-info",
                                                                  "model-metadata.json")):
                same[str(rel)] = (out / rel).read_bytes() == f.read_bytes()
    maps = IndexMap.load_directory(drivers / "distributed" / "index-maps")
    models = {"distributed": load_game_model(drivers / "distributed" / "best", maps, device=dev),
              "model_axis": load_game_model(out / "best", maps, device=dev)}
    gaps = {}
    for cid, m in models["distributed"].models.items():
        a = models["model_axis"].get(cid)
        ref_t = m.glm.coefficients.means if hasattr(m, "glm") else m.coefficients
        got_t = a.glm.coefficients.means if hasattr(a, "glm") else a.coefficients
        gaps[cid] = (float((got_t.double() - ref_t.double()).abs().max()),
                     float(ref_t.double().abs().max()))
    _log(f"14e. the GAME drivers with --mesh data=1,model=2 ({backend}, {card}) against phase "
         f"12(d)'s --distributed: {len(same)} index-map, metadata and id-info files "
         f"byte-identical {all(same.values())}; coefficient gaps (max |dw|, max |w|) "
         + json.dumps(gaps) + f"; written scores ({ranks[0]['rows']} rows) bitwise the "
         f"in-process feature-sharded ones {ranks[0]['written_scores_bitwise']}; seconds "
         + json.dumps([r["seconds"] for r in ranks]) + " (run beside (b) and (c) at 1x2)")
    assert same and all(same.values()), same
    assert all(g <= 1e-3 * s for g, s in gaps.values()), gaps
    assert all(r["distributed"] for r in ranks) and ranks[0]["written_scores_bitwise"]
    summary["e"] = {"byte_identical": len(same), "coefficient_gaps": gaps,
                    "seconds": [r["seconds"] for r in ranks]}

    path["sparse_gather"] = {
        "launches": launches_b["rows"] + launches_b["segments"] + launches_c["rows"]
        + launches_c["segments"] - launches_c["compact"],
        "row_kernel": launches_b["rows"] + launches_c["rows"],
        "segment_kernel": launches_b["segments"] + launches_c["segments"],
        "column_sharded_glm": launches_b, "fused": launches_c,
        "checks": [{k: v for k, v in c.items() if k != "chunks"} for c in checks_b + checks_c]}
    path["sparse_gather_chunks"] = {
        "launches": launches_b["chunks"] + launches_c["chunks"],
        "checks": [c["chunks"] for c in checks_b + checks_c if "chunks" in c]}
    path["sparse_gather_compact"] = {"launches": launches_c["compact"], "checks": compact_checks}
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    path["sparse_gather"]["summary"] = summary
    shutil.rmtree(base, ignore_errors=True)
    return path



#: phase 15, streamed GLM solves, checkpoints and recovery (ROADMAP item 16
#: step 1): phase 4's dense problem in chunks of 2^15 rows, phase 5's ELL in
#: chunks of 2^17 rows (L-BFGS at λ=1, phase 14's 20-iteration budget,
#: checkpointed every 5 iterations), phase 7's and 11's flagships resumed
#: from checkpoints, and the drivers' streaming and checkpoint flags. The
#: GLM driver streams 128 of phase 8's 4096 training rows in two chunks (the
#: Python codec decodes each epoch again); the GAME driver reads 2048
#: flagship-width rows.
STREAM = dict(dense_n=1 << 17, dense_chunk=1 << 15, lbfgs_iterations=20, tron_iterations=5,
              budget_iterations=5,
              sparse_chunk=1 << 17, sparse_iterations=20, save_every=5,
              driver_rows=128, driver_validation_rows=1024, driver_chunk=64,
              driver_iterations=3, game_rows=2048, game_validation_rows=512, sweeps=4)


def _stream_counts():
    from photon_ml_torch.ops import fused_glm, packed_glm, sparse_gather

    return {"fused_glm": fused_glm.launches, "fused_glm_reduce": fused_glm.reduce_launches,
            "rows": sparse_gather.launches, "segments": sparse_gather.segment_launches,
            "chunks": sparse_gather.chunk_launches,
            "packed_glm": packed_glm.packed_launches + packed_glm.columns_launches,
            "packed_glm_reduce": packed_glm.reduce_launches}


def _reset_stream_counts() -> None:
    from photon_ml_torch.ops import fused_glm, packed_glm, sparse_gather

    fused_glm.launches = fused_glm.reduce_launches = 0
    sparse_gather.launches = sparse_gather.segment_launches = sparse_gather.chunk_launches = 0
    for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
        setattr(packed_glm, name, 0)


class _ValueGradEpochs:
    """Counts the value+gradient epochs of streamed objectives while open
    (TRON's Hessian-vector epochs are counted apart), by wrapping the
    methods; restored on exit."""

    def __enter__(self):
        from photon_ml_torch.algorithm.streaming import StreamingGLMObjective

        self.value_grad = self.hessian_vector = 0
        self._saved = (StreamingGLMObjective.value_and_grad, StreamingGLMObjective.hessian_vector)
        vg, hv = self._saved

        def value_and_grad(obj, w):
            self.value_grad += 1
            return vg(obj, w)

        def hessian_vector(obj, w, v):
            self.hessian_vector += 1
            return hv(obj, w, v)

        StreamingGLMObjective.value_and_grad = value_and_grad
        StreamingGLMObjective.hessian_vector = hessian_vector
        return self

    def __exit__(self, *exc):
        from photon_ml_torch.algorithm.streaming import StreamingGLMObjective

        StreamingGLMObjective.value_and_grad, StreamingGLMObjective.hessian_vector = self._saved


def _streamed(torch, label: str, source, optimizer, lams, *, solves: list, **kw) -> dict:
    """``train_glm_streaming`` with the launch counters set to 0 just before
    and read just after; per λ its seconds, iterations and epochs. Returns
    the models, the launches and the epochs' totals."""
    from photon_ml_torch.estimators import train_glm_streaming
    from photon_ml_torch.types import TaskType

    marks = {"t": time.perf_counter()}
    totals: dict = {}

    def on_solve(lam, result, objective):
        torch.cuda.synchronize()
        now = time.perf_counter()
        solves.append({"run": label, "lambda": lam, "seconds": now - marks["t"],
                       "iterations": result.iterations, "reason": result.reason,
                       "value": float(result.value), "epochs": objective.epochs})
        for k, v in objective.totals.items():
            totals[k] = totals.get(k, 0.0) + v
        marks["t"] = now

    _reset_stream_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _ValueGradEpochs() as epochs:
        models = train_glm_streaming(source, TaskType.LOGISTIC_REGRESSION, optimizer=optimizer,
                                     regularization_weights=lams, on_solve=on_solve, **kw)
    torch.cuda.synchronize()
    return {"models": models, "launches": _stream_counts(), "seconds": time.perf_counter() - t0,
            "value_grad_epochs": epochs.value_grad, "hv_epochs": epochs.hessian_vector,
            "totals": totals}


def _means(models) -> dict:
    return {lam: m.coefficients.means.double().cpu() for lam, m in models.items()}


def _bitwise(a: dict, b: dict) -> bool:
    return all(a[k].equal(b[k]) for k in b)


def _stream_dense(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """15(a) and the streamed half of 15(c)."""
    from photon_ml_torch.algorithm.streaming import StreamingGLMObjective, streaming_summarize
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.io.checkpoint import SolverCheckpointer
    from photon_ml_torch.io.stream_reader import ArrayChunkSource
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.ops.normalization import (
        NormalizationContext,
        NormalizationType,
        build_normalization,
    )
    from photon_ml_torch.ops.objective import GLMObjective
    from photon_ml_torch.optim.common import ConvergenceReason
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.resilience import RetryPolicy, recovery, run_with_recovery
    from photon_ml_torch.types import TaskType

    n, d = STREAM["dense_n"], STREAM.get("dense_d", 512)
    chunk = STREAM["dense_chunk"]
    t0 = time.perf_counter()
    x_np, y_np = _dataset(np, seed, n, d)  # phase 4's generator
    source = ArrayChunkSource(x_np, y_np, chunk_rows=chunk)
    stats = streaming_summarize(source)
    norm = build_normalization(
        NormalizationType.STANDARDIZATION,
        **{k: torch.as_tensor(stats[k], dtype=torch.float64, device=dev)
           for k in ("mean", "variance", "max_magnitude")}, intercept_index=d - 1)
    norm = NormalizationContext(norm.factors.float(), norm.shifts.float())
    batch = LabeledPointBatch.create(x_np, y_np, device=dev)
    torch.cuda.synchronize()
    summarize_s = time.perf_counter() - t0
    _log(f"15a. phase 4's generator at [{n}, {d}] f32 in {source.num_chunks} chunks of {chunk} rows "
         f"({chunk * d * 4 / 2**20:.0f} MiB of features a chunk); streaming_summarize and the "
         f"in-core batch: {summarize_s:.2f} s")
    # phase 4's L-BFGS and TRON budgets
    lbfgs = OptimizerConfig(OptimizerType.LBFGS, max_iterations=STREAM["lbfgs_iterations"])
    tron = OptimizerConfig(OptimizerType.TRON, max_iterations=STREAM["tron_iterations"],
                           tolerance=1e-5)
    common = dict(normalization=norm, intercept_index=d - 1)
    solves: list = []

    def in_core(label, optimizer, lams):
        marks = {"t": time.perf_counter()}

        def on_solve(lam, result):
            torch.cuda.synchronize()
            now = time.perf_counter()
            solves.append({"run": label, "lambda": lam, "seconds": now - marks["t"],
                           "iterations": result.iterations, "reason": result.reason,
                           "value": float(result.value)})
            marks["t"] = now

        return train_glm(batch, TaskType.LOGISTIC_REGRESSION, optimizer=optimizer,
                         regularization_weights=lams, on_solve=on_solve, **common)

    # a budget short of the λ=1 solve's f32 resolution, where no stopping test
    # decides at the last ulp of the objective
    budget = OptimizerConfig(OptimizerType.LBFGS, max_iterations=STREAM["budget_iterations"])
    in_core("warm-up", lbfgs, (1.0,))  # the kernels' first calls outside the times
    ref = {"lbfgs": in_core("in-core lbfgs", lbfgs, (1.0, 10.0)),
           "tron": in_core("in-core tron", tron, (1.0,)),
           "budget": in_core("in-core budget", budget, (1.0,))}
    runs = {"lbfgs": _streamed(torch, "streamed lbfgs", source, lbfgs, (1.0, 10.0),
                               solves=solves, device=dev, **common),
            "lbfgs_off": _streamed(torch, "streamed lbfgs, prefetch off", source, lbfgs, (1.0,),
                                   solves=solves, device=dev, prefetch=False, **common),
            "tron": _streamed(torch, "streamed tron", source, tron, (1.0,), solves=solves,
                              device=dev, **common),
            "budget": _streamed(torch, "streamed budget", source, budget, (1.0,),
                                solves=solves, device=dev, **common)}
    ref["closed_form"] = train_glm(batch, TaskType.LOGISTIC_REGRESSION, optimizer=lbfgs,
                                   regularization_weights=(1.0, 10.0), use_kernel=False,
                                   **common)
    by = {(s["run"], s["lambda"]): s for s in solves}
    gaps = {}
    problems = []
    budget_stop = int(ConvergenceReason.MAX_ITERATIONS)
    for kind, lams in (("lbfgs", (1.0, 10.0)), ("tron", (1.0,)), ("budget", (1.0,))):
        want, got = _means(ref[kind]), _means(runs[kind]["models"])
        for lam in lams:
            a, b = by[(f"in-core {kind}", lam)], by[(f"streamed {kind}", lam)]
            gap = float((got[lam] - want[lam]).abs().max())
            scale = float(want[lam].abs().max())
            value_rel = abs(a["value"] - b["value"]) / abs(a["value"])
            gaps[f"{kind} λ={lam:g}"] = {
                "iterations": [a["iterations"], b["iterations"]],
                "reasons": [a["reason"], b["reason"]], "max_dw": gap, "max_w": scale,
                "value_rel": value_rel}
            if kind == "lbfgs":
                cf = _means(ref["closed_form"])[lam]
                gaps[f"{kind} λ={lam:g}"]["closed_form_max_dw"] = float((cf - want[lam]).abs().max())
            if a["reason"] == b["reason"] == budget_stop:
                # both ran their budget: the same iterations, the same point
                if a["iterations"] != b["iterations"] or gap > 1e-4 * scale:
                    problems.append(("budget", kind, lam, gaps[f"{kind} λ={lam:g}"]))
            elif value_rel > 1e-6 or abs(a["iterations"] - b["iterations"]) > 1:
                # a stopping test fired at the objective's f32 resolution (the
                # relative decrease test at 1e-7, a line search finding no
                # lower f32 value): the same value, an iteration apart at most
                problems.append(("resolution", kind, lam, gaps[f"{kind} λ={lam:g}"]))
    _log("15a. streamed against in core, the closed form's gap to the kernel beside it "
         f"({card}): " + json.dumps(gaps))
    assert not problems, problems
    lb = runs["lbfgs"]
    assert _means(lb["models"])[1.0].equal(_means(runs["lbfgs_off"]["models"])[1.0]), \
        "prefetch on and off differ"
    for kind, run in runs.items():
        want = source.num_chunks * run["value_grad_epochs"]
        assert run["launches"]["fused_glm"] == run["launches"]["fused_glm_reduce"] == want > 0, \
            (kind, run["launches"], want)
    _log(f"15a. ({card}) prefetch on and off bitwise equal (two streamed runs: (c) repeats "
         "the path, bitwise); "
         "B1 launches = chunks x "
         "value+gradient epochs: " + json.dumps(
             {k: [r["launches"]["fused_glm"], source.num_chunks, r["value_grad_epochs"],
                  r["hv_epochs"]] for k, r in runs.items()}))
    for s in solves:
        if s["run"] != "warm-up":
            _log(f"15a. {s['run']} λ={s['lambda']:g} ({card}): {s['seconds']:.4f} s, "
                 f"{s['iterations']} iterations" + (f", {s['epochs']} epochs, "
                                                    f"{s['seconds'] / s['epochs']:.4f} s an epoch"
                                                    if "epochs" in s else ""))
    # one streamed evaluation against the in-core one at the same point (half
    # the λ=1 optimum, where the gradient is no cancellation): the chunked
    # epoch computes the same function up to f32 summation order
    w_eval = 0.5 * norm.from_model_space(_means(lb["models"])[1.0].float().to(dev), d - 1)
    obj = StreamingGLMObjective(source, LogisticLoss(), l2_weight=1.0, normalization=norm,
                                device=dev)
    sv, sg = obj.value_and_grad(w_eval)
    iv, ig = GLMObjective(LogisticLoss(), 1.0, normalization=norm).value_and_gradient(w_eval,
                                                                                      batch)
    eval_value_rel = abs(float(sv) - float(iv)) / abs(float(iv))
    eval_grad = float((sg.double() - ig.double()).abs().max())
    gmax = float(ig.abs().max())
    _log(f"15a. one streamed evaluation against the in-core one at half the streamed λ=1 "
         f"optimum ({card}): value {eval_value_rel:.3g} rel, gradient max |dg| {eval_grad:.3g} "
         f"(max |g| {gmax:.3g})")
    assert eval_value_rel <= 1e-5 and eval_grad <= 1e-4 * gmax, (eval_value_rel, eval_grad)
    # the split of an epoch: decode (the decode thread), the consumer's waits,
    # host-to-device copy and accumulation, once unsynchronized (the overlap)
    # and once with the device synchronized after each copy and accumulation
    loss = LogisticLoss()
    w = _means(lb["models"])[1.0].float().to(dev)
    w = norm.from_model_space(w, d - 1)
    split = {}
    for label, sync in (("overlapped", False), ("synchronized", True)):
        obj = StreamingGLMObjective(source, loss, l2_weight=1.0, normalization=norm, device=dev,
                                    sync_timing=sync)
        obj.value_and_grad(w)
        rows = []
        for _ in range(3):
            obj.value_and_grad(w)
            torch.cuda.synchronize()
            rows.append(dict(obj.last_epoch))
        split[label] = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    sync = split["synchronized"]
    copy_rate = sync["bytes"] / sync["copy"] / 1e9
    _log(f"15a. one epoch ({card}): " + json.dumps(split) + f"; {sync['bytes'] / 2**20:.1f} MiB "
         f"copied an epoch at {copy_rate:.2f} GB/s (pageable, synchronous); B1 a chunk "
         f"{sync['accumulate'] / sync['chunks'] * 1e3:.3f} ms of host-timed accumulation")

    # B1 and its reduce held on one chunk, at the streamed λ=1 coefficients
    cb = source.load(source.specs[0]).to_device(dev)
    xc = cb.features
    r = torch.rand(xc.shape[0], device=dev)
    kw = dict(l2_weight=0.0, normalization=norm)
    check = _path_check(
        torch, "15a. fused_glm on one chunk",
        lambda: fused_glm.fused_value_and_gradient(loss, w, cb, **kw),
        lambda: fused_glm.fused_value_and_gradient_reference(loss, w, cb, **kw),
        lambda: (torch.matmul(xc, w), torch.matmul(r, xc)), (1e-5, 1e-4),
        xc.shape[0] * xc.shape[1] * 4 + 12 * xc.shape[0] + 8 * d + 8, xc.shape)
    b1_args = (loss, xc, cb.labels, cb.offsets, cb.weights, w, None)
    reduce = _reduce_entry(torch, "15a. fused_glm_reduce on one chunk",
                           lambda: fused_glm.fused_partials(*b1_args), fused_glm.reduce_partials,
                           fused_glm.reduce_partials_reference)
    _log(f"15a. fused_glm on one chunk [{chunk}, {d}] ({card}): " + json.dumps(check))

    # 15c, streaming: one transient OSError(EIO) from the decode, mid-epoch in
    # the second λ, past a one-attempt retry policy; run_with_recovery
    # resumes from the solver checkpoint to run (a)'s bits
    first = by[("streamed lbfgs", 1.0)]["epochs"]
    fire_at = source.num_chunks * (first + 3) + source.num_chunks // 2
    loads = {"n": 0, "fired": False}

    def hook():
        loads["n"] += 1
        if loads["n"] == fire_at and not loads["fired"]:
            loads["fired"] = True
            raise OSError(errno.EIO, "Input/output error")

    flaky = ArrayChunkSource(x_np, y_np, chunk_rows=chunk, decode_hook=hook)
    ck = SolverCheckpointer(tmp / "dense-ck")
    recovery.reset_counts()
    t0 = time.perf_counter()
    _reset_stream_counts()
    models = run_with_recovery(
        lambda restart: _streamed(torch, f"recovered (restart {restart})", flaky, lbfgs,
                                  (1.0, 10.0), solves=[], device=dev, checkpointer=ck,
                                  retry_policy=RetryPolicy(max_attempts=1), **common)["models"],
        max_restarts=1, checkpointer=ck)
    recovered_s = time.perf_counter() - t0
    assert loads["fired"] and recovery.counts["checkpoint_restores"] == 1, (loads, recovery.counts)
    # the λ=1 solve ran whole before the failure: a second streamed run of
    # it; λ=10 resumed from the solver checkpoint
    assert _bitwise(_means(lb["models"]), _means(models)), "the recovered run differs"
    save_s = [s for _, s in ck.saves]
    _log(f"15c. streaming recovery ({card}): EIO at decode {fire_at} (λ=10, mid-epoch), one "
         f"restart, {recovery.counts['checkpoint_restores']} restore, "
         f"{recovery.counts['epochs_resumed']} epochs not redone, models bitwise run (a)'s; "
         f"{recovered_s:.2f} s with {len(ck.saves)} saves of {ck.saves[-1][0]} bytes "
         f"({statistics.median(save_s) * 1e3:.2f} ms each)")
    launches = {k: sum(run["launches"][k] for run in runs.values())
                for k in ("fused_glm", "fused_glm_reduce")}
    del batch, source, flaky, x_np
    torch.cuda.empty_cache()
    return {"fused_glm": dict(check, launches=launches["fused_glm"], chunk_shape=[chunk, d],
                              by_run={k: r["launches"]["fused_glm"] for k, r in runs.items()},
                              epoch=split, copy_GBps=copy_rate,
                              seconds={"in_core": {f"{s['run']} {s['lambda']:g}": s["seconds"]
                                                   for s in solves if "epochs" not in s},
                                       "streamed": {f"{s['run']} {s['lambda']:g}": s["seconds"]
                                                    for s in solves if "epochs" in s}}),
            "fused_glm_reduce": dict(reduce, launches=launches["fused_glm_reduce"])}


def _stream_sparse(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """15(b) and the sparse saves of 15(c)."""
    from photon_ml_torch.data.sparse_batch import transpose_plan
    from photon_ml_torch.io.checkpoint import SolverCheckpointer
    from photon_ml_torch.io.stream_reader import SparseArrayChunkSource
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType

    n, d, per_row, n_held = (SPARSE["ell"][k] for k in ("n", "d", "per_row", "held_out"))
    chunk = STREAM["sparse_chunk"]
    t0 = time.perf_counter()
    (rows, cols, vals, y), _ = _planted_ell_data(np, seed, n, d, per_row, n_held)
    source = SparseArrayChunkSource(rows, cols, vals, y, dim=d, chunk_rows=chunk,
                                    dtype=np.float32)
    del rows, cols, vals
    _log(f"15b. phase 5's ELL [{n} rows, d={d}] in {source.num_chunks} chunks of {chunk} rows, "
         f"ELL width {source.ell_width}: {time.perf_counter() - t0:.2f} s")
    lbfgs = OptimizerConfig(OptimizerType.LBFGS, max_iterations=STREAM["sparse_iterations"])
    ck = SolverCheckpointer(tmp / "sparse-ck", max_to_keep=1, save_every=STREAM["save_every"])
    solves: list = []
    run = _streamed(torch, "streamed ell lbfgs", source, lbfgs, (1.0,), solves=solves,
                    device=dev, checkpointer=ck)
    s = solves[-1]
    w = run["models"][1.0].coefficients.means.float()
    ref = _SHARED.get("ell_lbfgs")
    gap = scale = None
    if ref is not None:  # phase 5's in-core solve of the same problem
        want = torch.as_tensor(ref["w"], device=dev).double()
        gap, scale = float((w.double() - want).abs().max()), float(want.abs().max())
    launches = run["launches"]
    per_chunk = {k: launches[k] / (source.num_chunks * s["epochs"])
                 for k in ("rows", "segments", "chunks")}
    assert launches["rows"] + launches["segments"] > 0 and launches["fused_glm"] == 0, launches
    # the column-sorted plan of one chunk, rebuilt as every epoch rebuilds it
    cb = source.load(source.specs[0]).to_device(dev)
    plan_ms = []
    for _ in range(3):
        fresh = source.load(source.specs[0]).to_device(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        transpose_plan(fresh)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t1) * 1e3)
    checks = _fe_gather_checks(torch, "15b. chunk 0", cb, w)
    _log(f"15b. streamed ELL λ=1 ({card}): {s['iterations']} iterations, {s['epochs']} epochs in "
         f"{s['seconds']:.3f} s ({s['seconds'] / s['epochs']:.4f} s an epoch; phase 5 in core "
         f"{ref['solve']['seconds'] if ref else 'not run'} s), against phase 5's in-core "
         f"solve max |dw| {gap} (max |w| {scale}); G1 launches a chunk-epoch "
         + json.dumps(per_chunk) + f"; the chunk's transpose plan rebuilt in "
         f"{statistics.median(plan_ms):.3f} ms; epoch totals " + json.dumps(run["totals"]))
    assert gap is None or gap <= 1e-3 * scale, (gap, scale)
    _log(f"15c. sparse solver checkpoints every {ck.save_every} iterations ({card}): "
         + json.dumps([{"bytes": b, "seconds": round(sec, 4)} for b, sec in ck.saves]))
    assert len(ck.saves) >= 2
    del source, cb
    torch.cuda.empty_cache()
    out = {"sparse_gather": {"launches": launches["rows"] + launches["segments"],
                             "row_kernel": launches["rows"], "segment_kernel": launches["segments"],
                             "per_chunk_epoch": per_chunk, "plan_rebuild_ms": plan_ms,
                             "checks": [{k: v for k, v in c.items() if k != "chunks"}
                                        for c in checks],
                             "saves": ck.saves}}
    # the chunk kernel runs where a chunk's column holds more than
    # SEGMENT_CHUNK entries (the planted support's columns, about 2^17·4/256
    # entries a chunk): on this path only when the data puts one there
    if launches["chunks"]:
        out["sparse_gather_chunks"] = {"launches": launches["chunks"],
                                       "checks": [c["chunks"] for c in checks if "chunks" in c]}
    return out


def _stream_resumes(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """15(c): GameEstimator.fit and train_distributed resumed bitwise, and a
    sticky CUDA error not retried."""
    import dataclasses

    from photon_ml_torch import convert
    from photon_ml_torch.io.checkpoint import TrainingCheckpointer
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh
    from photon_ml_torch.resilience import TransientError, recovery, run_with_recovery

    # GameEstimator.fit: phase 7's flagship, L-BFGS lanes, a transient error
    # after update 5, resumed from the per-update checkpoints
    shape = GAME["flagship"]
    sweeps = STREAM["sweeps"]
    train, _ = _game_arrays(np, seed, **dict(shape, held_out=0))
    ds = _game_dataset(train, "LOGISTIC_REGRESSION", dev)
    del train
    est = _game_estimator("LOGISTIC_REGRESSION", "LBFGS", sweeps)
    t0 = time.perf_counter()
    whole = est.fit(ds)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    ck = TrainingCheckpointer(tmp / "cd-ck")
    updates = {"n": 0}

    def stop(iteration, cid, info):
        updates["n"] += 1
        if updates["n"] == 5:
            raise TransientError("stopped after update 5")

    recovery.reset_counts()
    _reset_stream_counts()
    t0 = time.perf_counter()
    resumed = run_with_recovery(
        lambda restart: dataclasses.replace(est, checkpointer=ck, on_update=stop).fit(ds),
        max_restarts=1, checkpointer=ck)
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    cd_launches = _stream_counts()
    a, b = convert.game_model_to_numpy(whole.model), convert.game_model_to_numpy(resumed.model)
    same = all(np.array_equal(a[c][k], b[c][k]) for c in a for k in a[c]
               if isinstance(a[c][k], np.ndarray))
    assert same and recovery.counts["checkpoint_restores"] == 1, recovery.counts
    assert cd_launches["packed_glm"] == cd_launches["packed_glm_reduce"] > 0, cd_launches
    _log(f"15c. GameEstimator.fit, phase 7's flagship, {sweeps} sweeps ({card}): stopped after "
         f"update 5 and resumed, models bitwise the uninterrupted fit's; {whole_s:.2f} s "
         f"uninterrupted, {resumed_s:.2f} s stopped and resumed with {len(ck.steps())} steps "
         f"kept (last {ck.latest_step()}, {ck.last_save['bytes']} bytes, "
         f"{ck.last_save['seconds'] * 1e3:.2f} ms); launches " + json.dumps(cd_launches))
    # the packed kernel on the resumed fit's fixed effect
    loss = LogisticLoss()
    x = ds.feature_shards["global"]
    fixed = resumed.model.get("fixed")
    w = fixed.glm.coefficients.means.float().contiguous()
    aux = packed_glm.pack_aux(ds.labels, ds.offsets + resumed.model.score(ds) - x @ w, ds.weights)
    n = x.shape[0]
    r = torch.rand(n, device=dev)
    packed = _path_check(
        torch, "15c. packed_glm on the resumed fit's fixed effect",
        lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
        lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
        lambda: (torch.matmul(x, w), torch.matmul(r, x)), (1e-5, 1e-4),
        x.shape[0] * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8, x.shape)
    fe_args = (loss, x, aux, None, None, None, w, None, False, "fma", "fma")
    packed_reduce = _reduce_entry(torch, "15c. packed_glm_reduce on the resumed fit",
                                  lambda: packed_glm.launch_partials(*fe_args),
                                  packed_glm.reduce_partials, packed_glm.reduce_partials_reference)
    del ds, x, aux, whole, resumed
    torch.cuda.empty_cache()

    # train_distributed: phase 11's fused flagship with MF over a one-rank
    # NCCL mesh, two sweeps checkpointed, then the four-sweep run resumed
    info = multihost.initialize(device=None if dev.type == "cuda" else dev)
    try:
        mesh = make_mesh()
        ds, _, re_ds, mf_ds = _mesh_flagship(np, seed, dev)
        program = _fused_program(k=MESH["k"], alternations=MESH["alternations"],
                                 mf_l2=MESH["mf_l2"], mesh=mesh)
        kw = dict(mf_datasets=mf_ds, mesh=mesh)
        t0 = time.perf_counter()
        whole = dist.train_distributed(program, ds, re_ds, num_iterations=sweeps, **kw)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        fck = TrainingCheckpointer(tmp / "fused-ck")
        dist.train_distributed(program, ds, re_ds, num_iterations=sweeps // 2,
                               checkpointer=fck, **kw)
        recovery.reset_counts()
        _reset_stream_counts()
        t0 = time.perf_counter()
        resumed = dist.train_distributed(program, ds, re_ds, num_iterations=sweeps,
                                         checkpointer=fck, **kw)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        fused_launches = _stream_counts()
        fa = _flat_state(convert.train_state_to_numpy(whole.state))
        fb = _flat_state(convert.train_state_to_numpy(resumed.state))
        gap, scale, bitwise = _state_gap(np, fa, fb)
        assert bitwise and resumed.losses == whole.losses, (gap, scale)
        assert recovery.counts["checkpoint_restores"] == 1
        assert fused_launches["fused_glm"] == fused_launches["fused_glm_reduce"] > 0
        _log(f"15c. train_distributed, phase 11's flagship with MF on a one-rank "
             f"{info.backend} mesh ({card}): {sweeps // 2} sweeps checkpointed, the "
             f"{sweeps}-sweep run resumed from step {sweeps // 2}: state and losses bitwise the "
             f"uninterrupted run's; {whole_s:.2f} s uninterrupted, {resumed_s:.2f} s for the "
             f"resumed half; checkpoint {fck.last_save['bytes']} bytes in "
             f"{fck.last_save['seconds'] * 1e3:.2f} ms; launches " + json.dumps(fused_launches))
        del ds, re_ds, mf_ds, whole, resumed
    finally:
        multihost.shutdown()
    torch.cuda.empty_cache()

    # a sticky CUDA error is fatal: run_with_recovery makes no second attempt
    attempts = []

    def sticky(restart):
        attempts.append(restart)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    try:
        run_with_recovery(sticky, max_restarts=3)
    except RuntimeError as e:
        assert "illegal memory access" in str(e)
    assert attempts == [0], attempts
    _log("15c. a sticky CUDA error (illegal memory access) was not retried: 1 attempt")
    return {"packed_glm": dict(packed, launches=cd_launches["packed_glm"]),
            "packed_glm_reduce": dict(packed_reduce, launches=cd_launches["packed_glm_reduce"]),
            "fused_glm": fused_launches["fused_glm"],
            "fused_glm_reduce": fused_launches["fused_glm_reduce"]}


def _stream_drivers(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """15(d): the GLM driver streamed against in core, prefetch on against
    off; the GAME driver with --checkpoint-dir run twice."""
    from photon_ml_torch.cli import game_training_driver, glm_driver
    from photon_ml_torch.io import avro, photon_schemas
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration
    from photon_ml_torch.io.stream_reader import (
        AvroChunkSource,
        ChunkPrefetcher,
        DenseRecordAssembler,
        build_streaming_index_maps,
    )
    from photon_ml_torch.resilience import recovery

    ng, nv, dg = STREAM["driver_rows"], STREAM["driver_validation_rows"], DRIVERS["glm_d"]
    x, y = _dataset(np, seed + 4, DRIVERS["glm_rows"] + DRIVERS["glm_validation_rows"], dg)
    xl, yl = x[:, :-1].tolist(), y.tolist()  # phase 8's rows; the last column is the intercept
    vlo = DRIVERS["glm_rows"]

    def records(lo, count):
        return ({"uid": str(lo + i), "label": yl[lo + i], "features": _ntv("f", xl[lo + i]),
                 "weight": 1.0, "offset": 0.0, "foldId": None, "metadataMap": None}
                for i in range(count))

    te = photon_schemas.TRAINING_EXAMPLE_AVRO
    for split, lo, count in (("train", 0, ng), ("validation", vlo, nv)):
        os.makedirs(tmp / "glm" / split, exist_ok=True)
        avro.write_container(tmp / "glm" / split / "part-00000.avro", te, records(lo, count),
                             block_records=STREAM["driver_chunk"])
    del x, y, xl, yl
    # the stream decode's rate (the Python codec, one pass)
    cfg = {"features": FeatureShardConfiguration(feature_bags=("features",))}
    files = [str(tmp / "glm/train/part-00000.avro")]
    maps = build_streaming_index_maps(files, cfg)
    src = AvroChunkSource(files, DenseRecordAssembler(maps["features"], cfg["features"]),
                          chunk_records=STREAM["driver_chunk"])
    with ChunkPrefetcher(src, prefetch=False) as it:
        for _ in it:
            pass
        decode_s = it.decode_seconds
    rate = src.total_records / decode_s

    def glm(out, *extra):
        _reset_stream_counts()
        t0 = time.perf_counter()
        result = glm_driver.main([
            "--input-data-path", str(tmp / "glm/train"), "--validation-data-path",
            str(tmp / "glm/validation"), "--output-dir", str(tmp / "glm" / out),
            "--task-type", "LOGISTIC_REGRESSION", "--regularization-weights", "1",
            "--max-iterations", str(STREAM["driver_iterations"]), *extra], device=dev)
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, _stream_counts()

    chunks = ("--streaming-chunks", str(STREAM["driver_chunk"]))
    in_core, in_core_s, _ = glm("in-core")
    on, on_s, on_launches = glm("streamed", *chunks)
    off, off_s, _ = glm("streamed-off", *chunks, "--no-streaming-prefetch")
    wa = in_core.models[1.0].coefficients.means.double()
    wb = on.models[1.0].coefficients.means.double()
    gap = float((wa - wb).abs().max()) / float(wa.abs().max())
    text = {k: (tmp / "glm" / k / "models-text" / "1.0.txt").read_bytes()
            for k in ("streamed", "streamed-off")}
    assert gap <= 1e-3 and text["streamed"] == text["streamed-off"], gap
    assert on_launches["fused_glm"] > 0 and on.stage.name == "VALIDATED"
    _log(f"15d. GLM driver on {ng} of phase 8's rows, d={dg}, --streaming-chunks "
         f"{STREAM['driver_chunk']} ({src.num_chunks} chunks) ({card}): coefficients {gap:.3g} "
         f"rel of the in-core run's, prefetch on and off byte-identical models; seconds in core "
         f"{in_core_s:.2f}, streamed {on_s:.2f}, prefetch off {off_s:.2f}; stream decode "
         f"{rate:.0f} records/s (Python codec); B1 launches {on_launches['fused_glm']}")

    # the GAME training driver with --checkpoint-dir, run twice
    shape = dict(GAME["flagship"], n=STREAM["game_rows"], held_out=STREAM["game_validation_rows"])
    train, held = _game_arrays(np, seed + 5, **shape)
    for args in _game_parts(train, tmp / "game/train", 0, 1) \
            + _game_parts(held, tmp / "game/validation", shape["n"], 1):
        _write_game_part(args)
    del train, held
    shards = ["--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
              "--feature-shard-configurations",
              "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
    re_spec = "feature.shard=per_entity,reg.weights=1,max.iter=10,random.effect.type="

    def game(out):
        _reset_stream_counts()
        t0 = time.perf_counter()
        summary = game_training_driver.main([
            "--input-data-path", str(tmp / "game/train"), "--validation-data-path",
            str(tmp / "game/validation"), "--root-output-dir", str(tmp / "game" / out),
            "--task-type", "LOGISTIC_REGRESSION", *shards, "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--coordinate-configurations", f"name=per_user,{re_spec}userId",
            "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC",
            "--checkpoint-dir", str(tmp / "game/ck")], device=dev)
        torch.cuda.synchronize()
        return summary, time.perf_counter() - t0, _stream_counts()

    first, first_s, first_launches = game("first")
    recovery.reset_counts()
    again, again_s, _ = game("again")

    def model_files(root):
        return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
                if p.is_file() and str(p.relative_to(root)).startswith(("models", "best"))}

    same = model_files(tmp / "game/first") == model_files(tmp / "game/again")
    assert same and recovery.counts["checkpoint_restores"] == 1, recovery.counts
    assert first_launches["packed_glm"] > 0, first_launches
    _log(f"15d. GAME driver with --checkpoint-dir on {shape['n']} flagship-width rows ({card}): "
         f"{first_s:.2f} s, then again {again_s:.2f} s resuming at the last step "
         f"({recovery.counts['checkpoint_restores']} restore), byte-identical model files "
         f"({len(model_files(tmp / 'game/first'))}); best AUC {first['best_metric']:.6f}")
    return {"fused_glm": on_launches["fused_glm"], "fused_glm_reduce": on_launches["fused_glm_reduce"],
            "packed_glm": first_launches["packed_glm"],
            "packed_glm_reduce": first_launches["packed_glm_reduce"]}


def _stream_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 15: streamed GLM solves, checkpoints and recovery, printing as
    it goes. Returns, for each kernel this path runs, its launches here and
    its checks on the path's own inputs (chunk-sized for B1 and G1)."""
    t_phase = time.perf_counter()
    base = Path(tempfile.mkdtemp(prefix="stream-", dir=Path(__file__).resolve().parent / "build"))
    try:
        times = {}
        t0 = time.perf_counter()
        path = _stream_dense(torch, np, seed, dev, card, base)
        times["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        path.update(_stream_sparse(torch, np, seed, dev, card, base))
        times["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumes = _stream_resumes(torch, np, seed, dev, card, base)
        times["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        drivers = _stream_drivers(torch, np, seed, dev, card, base)
        times["d"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    for name in ("fused_glm", "fused_glm_reduce"):
        path[name]["launches"] += resumes[name] + drivers[name]
        path[name]["resumed_fused_run"], path[name]["driver"] = resumes[name], drivers[name]
    for name in ("packed_glm", "packed_glm_reduce"):
        path[name] = dict(resumes[name], driver=drivers[name])
        path[name]["launches"] += drivers[name]
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    seconds = time.perf_counter() - t_phase
    path["fused_glm"]["phase_seconds"] = seconds
    _log(f"15. stream phase ({card}): {seconds:.2f} s (a {times['a']:.2f}, b {times['b']:.2f}, "
         f"c {times['c']:.2f}, d {times['d']:.2f})")
    return path


#: phase 16, streamed GAME over entity-clustered chunks, two ranks and
#: coordinated recovery (ROADMAP item 16 step 2): (a)-(b) the flagship's
#: widths with half its rows (2^16 rows, a [2^16, 256] f32 fixed-effect
#: block, 16 per-user features, 2000 users) in memory, in chunks of about
#: 2^14 rows (the rows cut for the script's time: a streamed sweep is host
#: work over every chunk);
#: (c)-(e) the flagship's rows of its first users as user-clustered Avro (the
#: Python codec decodes every chunk again each epoch, 2 ms a record on the
#: card's host, so the Avro runs are cut in depth, never in width). The
#: streamed model is FE + per-user: the flagship's items span any
#: user-clustered chunking, and streamed GAME needs every RE type clustered.
STREAM_GAME = dict(rows=1 << 16, chunk=1 << 14, sweeps=4, fe_iterations=10, re_iterations=10,
                   budget_fe_iterations=2, budget_re_iterations=2,
                   duhl_working_set=3, duhl_tail=1, duhl_tolerance=5e-4, duhl_sweeps=5,
                   avro_rows=256, avro_validation_rows=256, avro_chunk=64, avro_sweeps=2,
                   driver_sweeps=3, avro_fe_iterations=2, avro_re_iterations=5,
                   avro_duhl_working_set=2,
                   exchange_timeout_s=30.0,
                   fatal_timeout_s=5.0, rank_timeout_s=600)


def _sg_entity_idx(np, keys):
    vocab = np.unique(keys)
    return vocab, np.searchsorted(vocab, keys).astype(np.int32)


def _sg_specs(fe_iterations: int, re_iterations: int, re_type: str = "user",
              fe_shard: str = "global", re_shard: str = "per_entity"):
    """The streamed model's specs: L-BFGS on both coordinates, fixed budgets
    (tolerance 0: no stopping test ends a solve early on the objective's f32
    resolution), L2 weight 1 (bench.py's configuration)."""
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.parallel import distributed as dist

    def opt(iterations):
        return OptimizerConfig(OptimizerType.LBFGS, max_iterations=iterations, tolerance=0.0)

    return (dist.FixedEffectStepSpec(fe_shard, opt(fe_iterations), l2_weight=1.0),
            (dist.RandomEffectStepSpec(re_type, re_shard, opt(re_iterations), l2_weight=1.0),))


def _sg_run(torch, program, label: str, sweeps: int, **kw) -> dict:
    """``program.train`` with B1's counters set to 0 just before and read
    just after, its value+gradient epochs counted; seconds synchronized."""
    _reset_stream_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _ValueGradEpochs() as epochs:
        result = program.train(num_sweeps=sweeps, **kw)
    torch.cuda.synchronize()
    return {"label": label, "result": result, "seconds": time.perf_counter() - t0,
            "launches": _stream_counts(), "epochs": epochs.value_grad,
            "timings": dict(program.timings), "cache_bytes": program.cache_bytes()}


def _sg_state(result) -> dict:
    st = result.state
    return {"fe": st.fe_coefficients.double().cpu(),
            **{f"re/{k}": v.double().cpu() for k, v in st.re_tables.items()}}


def _sg_gap(a: dict, b: dict) -> dict:
    """Per array: max |a - b| as a share of max |b|."""
    return {k: float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30) for k in b}


def _sg_flagship(np, seed: int, rows: int | None = None):
    """The flagship's training rows (FE + per-user), ``rows`` of them
    (``STREAM_GAME["rows"]`` by default), sorted by user, as streamed GAME
    needs them (stable: a user's rows keep their order), its user vocabulary
    and per-row user indexes."""
    train, _ = _game_arrays(np, seed, **dict(GAME["flagship"], n=rows or STREAM_GAME["rows"],
                                             held_out=0))
    order = np.argsort(train["keys"]["user"], kind="stable")
    train = {"x_fe": train["x_fe"][order], "x_re": train["x_re"][order],
             "keys": {"user": train["keys"]["user"][order]},
             "labels": {t: v[order] for t, v in train["labels"].items()}}
    vocab, user_idx = _sg_entity_idx(np, train["keys"]["user"])
    return train, vocab, user_idx


class _SyncedFeEpochs:
    """While active, the streamed GAME program's FE objectives synchronize
    the device after each chunk's copy and accumulation, so the program's
    timings split its FE epochs exactly."""

    def __enter__(self):
        from photon_ml_torch.algorithm import streaming, streaming_game

        base = streaming.StreamingGLMObjective

        class Synced(base):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **dict(kwargs, sync_timing=True))

        self._restore = (streaming_game, base)
        streaming_game.StreamingGLMObjective = Synced
        return self

    def __exit__(self, *exc):
        module, base = self._restore
        module.StreamingGLMObjective = base


def _stream_game_memory(torch, np, seed: int, dev, card: str) -> tuple:
    """16(a) and 16(b): the flagship in memory, streamed against in core, and
    DuHL against uniform. Returns the kernels' entries and the one-rank
    streamed states (f32 and f64) that 16(c)'s two ranks are held to."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.algorithm.streaming_game import (
        DuHLChunkSchedule,
        DuHLScheduleConfig,
        StreamingGameProgram,
        UniformChunkSchedule,
    )
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.io.stream_reader import GameArrayChunkSource
    from photon_ml_torch.ops import fused_glm, packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.types import TaskType

    cfg = STREAM_GAME
    shape = dict(GAME["flagship"], n=cfg["rows"], held_out=0)
    t0 = time.perf_counter()
    train, vocab, user_idx = _sg_flagship(np, seed)
    y = train["labels"]["LOGISTIC_REGRESSION"]
    source = GameArrayChunkSource(features={"global": train["x_fe"], "per_entity": train["x_re"]},
                                  labels=y, entity_idx={"user": user_idx},
                                  chunk_records=cfg["chunk"], cluster_by="user")
    specs = {"bench": _sg_specs(cfg["fe_iterations"], cfg["re_iterations"]),
             "budget": _sg_specs(cfg["budget_fe_iterations"], cfg["budget_re_iterations"])}
    caps = (GAME["cap"],)

    def program(schedule=None, budgets="bench", **kw):
        fe, res = specs[budgets]
        return StreamingGameProgram(TaskType.LOGISTIC_REGRESSION, source, fe, res,
                                    bucket_sizes=caps, schedule=schedule, device=dev, **kw)

    _log(f"16a. the flagship in memory: {shape['n']} rows, global [{shape['n']}, "
         f"{shape['d_fe']}] f32, per_entity 16, {len(vocab)} users, in {source.num_chunks} "
         f"user-clustered chunks of at most {source.chunk_rows} rows "
         f"({source.chunk_rows * shape['d_fe'] * 4 / 2**20:.1f} MiB of FE features a chunk); "
         f"data {time.perf_counter() - t0:.2f} s")
    sweeps = cfg["sweeps"]
    # the main path at bench.py's budgets: the uniform schedule, then
    # schedule=None with its epochs synchronized for the split (bitwise the
    # first); then, at budgets short of the f32 resolution, the streamed run
    # twice (bitwise) against the in-core fit
    budget = _sg_run(torch, program(budgets="budget"), "budgets", sweeps)  # first calls too
    again = _sg_run(torch, program(budgets="budget"), "budgets, again", sweeps)
    uniform = _sg_run(torch, program(UniformChunkSchedule(source.num_chunks), budgets="budget"),
                      "budgets, uniform schedule", sweeps)
    with _SyncedFeEpochs():
        main = _sg_run(torch, program(), "bench budgets, synchronized", sweeps)
    bref = _sg_state(budget["result"])
    for run, what in ((again, "a second run"), (uniform, "the uniform schedule")):
        assert run["result"].losses == budget["result"].losses and all(
            _sg_state(run["result"])[k].equal(bref[k]) for k in bref), f"{what} differs"
    ref = _sg_state(main["result"])
    for run in (main, budget, again, uniform):
        want = source.num_chunks * run["epochs"]
        assert run["launches"]["fused_glm"] == run["launches"]["fused_glm_reduce"] == want > 0, \
            (run["label"], run["launches"], want)
    t = main["timings"]
    per_sweep = {k: v / sweeps for k, v in t.items()}
    _log(f"16a. streamed sweeps at bench.py's budgets, the FE epochs synchronized for the split "
         f"({card}): {sweeps} sweeps in {main['seconds']:.3f} s ({main['seconds'] / sweeps:.3f} s "
         f"a sweep), losses {main['result'].losses}; at the short budgets schedule=None twice and "
         f"the uniform schedule bitwise equal; B1 launches = chunks x value+gradient epochs = {source.num_chunks} x "
         f"{main['epochs']} = {main['launches']['fused_glm']}; chunk loads a sweep "
         f"{main['result'].chunk_loads / sweeps:.1f}")
    _log(f"16a. a streamed sweep's split, synchronized ({card}): " + json.dumps(
        {k: round(v, 6) for k, v in per_sweep.items()}) + f"; copy rate "
        f"{t['fe_bytes'] / max(t['fe_copy'], 1e-9) / 1e9:.2f} GB/s (pageable)")

    # the in-core fit of the same model, at the budgets (FE, RE) of the
    # comparison run: with bench.py's 10 and 10 the last iterations of each
    # solve decide at the objective's f32 resolution, where two summation
    # orders part (ROADMAP queue C)
    def opt(iterations):
        from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType

        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType.LBFGS, max_iterations=iterations,
                                      tolerance=0.0), l2_weight=1.0)

    dataset = _game_dataset(dict(train, keys={"user": train["keys"]["user"]}),
                            "LOGISTIC_REGRESSION", dev, vocabs={"user": vocab})
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": FixedEffectCoordinateConfig("global", opt(cfg["budget_fe_iterations"])),
        "per_user": RandomEffectCoordinateConfig("user", "per_entity",
                                                 opt(cfg["budget_re_iterations"]),
                                                 bucket_sizes=caps)}, num_iterations=sweeps)
    est.fit(dataset)  # first calls
    for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
        setattr(packed_glm, name, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = est.fit(dataset)
    torch.cuda.synchronize()
    in_core_s = time.perf_counter() - t0
    packed_launches = packed_glm.packed_launches + packed_glm.columns_launches
    packed_reduce = packed_glm.reduce_launches

    def fit_state(f):
        return {"fe": f.model.get("fixed").glm.coefficients.means.double().cpu(),
                "re/user": f.model.get("per_user").coefficients.double().cpu()}

    in_core = fit_state(fit)
    gaps = _sg_gap(bref, in_core)
    # the training loss after each sweep (the in-core fit's after each
    # per-user update): the same objective, to f32 rounding
    in_core_losses = [h["train:LOGISTIC_LOSS"] for h in fit.metric_history
                      if h["coordinate"] == "per_user"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(budget["result"].losses, in_core_losses))
    # one sweep from zero, before any warm-started lane decides at f32
    # resolution, both coordinates whole
    first = program(budgets="budget").train(num_sweeps=1)
    first_fit = dataclasses.replace(est, num_iterations=1).fit(dataset)
    first_gaps = _sg_gap(_sg_state(first), fit_state(first_fit))
    _log(f"16a. streamed against GameEstimator.fit on the same model, budgets FE "
         f"{cfg['budget_fe_iterations']} / RE {cfg['budget_re_iterations']} iterations ({card}): "
         f"after one sweep max |dw| / max|w| " + json.dumps(first_gaps) + f"; after {sweeps} "
         + json.dumps(gaps) + f", training losses {loss_rel:.3g} rel apart at most; in core "
         f"{in_core_s:.3f} s ({in_core_s / sweeps:.3f} s a sweep), streamed "
         f"{budget['seconds'] / sweeps:.3f} s a sweep ({budget['seconds'] / in_core_s:.1f}x)")
    # the fixed effect within 1e-4·max|w| throughout, the random effect after
    # its first solve; from the second sweep on a warm-started lane's line
    # search decides at the objective's f32 resolution, where the card's
    # batched products round differently for a chunk's lanes and the whole
    # bucket's (ROADMAP queue C), so there the objective is held
    assert all(g <= 1e-4 for g in first_gaps.values()) and gaps["fe"] <= 1e-4, \
        (first_gaps, gaps)
    assert loss_rel <= 1e-6, (budget["result"].losses, in_core_losses)
    # the same comparison in f64, where the lanes solve in f64 and no
    # line-search decision rests on the objective's resolution: the user
    # table is held after four sweeps too (B1 and the packed kernel still
    # accumulate the fixed effect's products in f32 inside)
    fe_b, res_b = specs["budget"]
    src64 = GameArrayChunkSource(
        features={"global": train["x_fe"].astype(np.float64),
                  "per_entity": train["x_re"].astype(np.float64)},
        labels=y.astype(np.float64), entity_idx={"user": user_idx}, chunk_records=cfg["chunk"],
        cluster_by="user")
    f64 = _sg_run(torch, StreamingGameProgram(TaskType.LOGISTIC_REGRESSION, src64, fe_b, res_b,
                                              bucket_sizes=caps, device=dev),
                  "budgets, f64", sweeps)
    want = source.num_chunks * f64["epochs"]
    assert f64["launches"]["fused_glm"] == f64["launches"]["fused_glm_reduce"] == want, \
        (f64["launches"], want)
    ds64 = _game_dataset(dict(train, keys={"user": train["keys"]["user"]}),
                         "LOGISTIC_REGRESSION", dev, vocabs={"user": vocab}, dtype=np.float64)
    gaps64 = _sg_gap(_sg_state(f64["result"]), fit_state(est.fit(ds64)))
    _log(f"16a. the same in f64 ({card}): after {sweeps} sweeps max |dw| / max|w| "
         + json.dumps(gaps64) + f"; streamed {f64['seconds'] / sweeps:.3f} s a sweep")
    assert all(g <= 1e-4 for g in gaps64.values()), gaps64
    one_rank = {"f32": {k: v.tolist() for k, v in bref.items()},
                "f64": {k: v.tolist() for k, v in _sg_state(f64["result"]).items()},
                "losses": {"f32": budget["result"].losses, "f64": f64["result"].losses},
                "seconds": {"f32": budget["seconds"], "f32_repeat": again["seconds"],
                            "f64": f64["seconds"]}}
    del src64, ds64
    # the in-core sweep at bench.py's budgets, beside the streamed one
    est_bench = GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": FixedEffectCoordinateConfig("global", opt(cfg["fe_iterations"])),
        "per_user": RandomEffectCoordinateConfig("user", "per_entity", opt(cfg["re_iterations"]),
                                                 bucket_sizes=caps)}, num_iterations=sweeps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bench_fit = est_bench.fit(dataset)
    torch.cuda.synchronize()
    in_core_bench_s = time.perf_counter() - t0
    bench_gaps = _sg_gap(ref, {
        "fe": bench_fit.model.get("fixed").glm.coefficients.means.double().cpu(),
        "re/user": bench_fit.model.get("per_user").coefficients.double().cpu()})
    _log(f"16a. at bench.py's budgets (10 / 10) ({card}): in core {in_core_bench_s:.3f} s "
         f"({in_core_bench_s / sweeps:.3f} s a sweep) against streamed "
         f"{main['seconds'] / sweeps:.3f} s a sweep ({main['seconds'] / in_core_bench_s:.1f}x); "
         f"the two end max |dw| / max|w| " + json.dumps(bench_gaps) + " apart")
    del bench_fit

    # B1 and its reduce on one chunk, at the streamed fixed effect, with the
    # residual offsets of the final state
    loss = LogisticLoss()
    chunk = source.load(source.specs[0])
    from photon_ml_torch.data.batch import LabeledPointBatch

    w = main["result"].state.fe_coefficients.float()
    cb = LabeledPointBatch(features=torch.from_numpy(chunk.features["global"]).to(dev),
                           labels=torch.from_numpy(chunk.labels).to(dev),
                           offsets=torch.from_numpy(chunk.offsets).to(dev),
                           weights=torch.from_numpy(chunk.weights).to(dev))
    xc = cb.features
    r = torch.rand(xc.shape[0], device=dev)
    check = _path_check(
        torch, "16a. fused_glm on one GAME chunk",
        lambda: fused_glm.fused_value_and_gradient(loss, w, cb, l2_weight=0.0),
        lambda: fused_glm.fused_value_and_gradient_reference(loss, w, cb, l2_weight=0.0),
        lambda: (torch.matmul(xc, w), torch.matmul(r, xc)), (1e-5, 1e-4),
        xc.shape[0] * xc.shape[1] * 4 + 12 * xc.shape[0] + 8 * xc.shape[1] + 8, xc.shape)
    b1_args = (loss, xc, cb.labels, cb.offsets, cb.weights, w, None)
    reduce = _reduce_entry(torch, "16a. fused_glm_reduce on one GAME chunk",
                           lambda: fused_glm.fused_partials(*b1_args), fused_glm.reduce_partials,
                           fused_glm.reduce_partials_reference)
    _log(f"16a. fused_glm on one GAME chunk {list(xc.shape)} ({card}): " + json.dumps(check))
    # the packed kernel on the in-core fit's fixed effect (the comparison fit)
    x = dataset.feature_shards["global"]
    wf = in_core["fe"].float().to(dev)
    aux = packed_glm.pack_aux(dataset.labels, dataset.offsets + fit.model.score(dataset) - x @ wf,
                              dataset.weights)
    rp = torch.rand(x.shape[0], device=dev)
    packed = _path_check(
        torch, "16a. packed_glm on the in-core fit's fixed effect",
        lambda: packed_glm.packed_core(loss, x, aux, wf, with_rsum=False),
        lambda: packed_glm.packed_core_reference(loss, x, aux, wf, with_rsum=False),
        lambda: (torch.matmul(x, wf), torch.matmul(rp, x)), (1e-5, 1e-4),
        x.shape[0] * x.shape[1] * 4 + 12 * x.shape[0] + 8 * x.shape[1] + 8, x.shape)
    fe_args = (loss, x, aux, None, None, None, wf, None, False, "fma", "fma")
    packed_red = _reduce_entry(torch, "16a. packed_glm_reduce on the in-core fit",
                               lambda: packed_glm.launch_partials(*fe_args),
                               packed_glm.reduce_partials, packed_glm.reduce_partials_reference)
    del dataset, x, aux, fit, cb, xc

    # 16b: DuHL against uniform, both to the same loss tolerance
    duhl_runs = {}
    for name, schedule in (
            ("uniform", None),
            ("duhl", DuHLChunkSchedule(DuHLScheduleConfig(
                working_set_chunks=cfg["duhl_working_set"],
                tail_chunks_per_sweep=cfg["duhl_tail"]), source.num_chunks))):
        run = _sg_run(torch, program(schedule), name, cfg["duhl_sweeps"],
                      tolerance=cfg["duhl_tolerance"])
        duhl_runs[name] = run
        res_ = run["result"]
        _log(f"16b. {name} to relative loss decrease {cfg['duhl_tolerance']:g} ({card}): "
             f"{res_.sweeps} sweeps, {res_.chunk_loads} chunk loads, {res_.chunk_visits} RE "
             f"chunk visits, {run['seconds']:.3f} s, final loss {res_.losses[-1]:.8f}, pinned "
             f"cache {run['cache_bytes']} host bytes (no device memory)")
    u, dh = duhl_runs["uniform"]["result"], duhl_runs["duhl"]["result"]
    assert np.isfinite(dh.losses).all() and dh.chunk_visits <= u.chunk_visits
    del train, source
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in (main, budget, again, uniform, f64,
                                                  *duhl_runs.values()))
                for k in ("fused_glm", "fused_glm_reduce")}
    summary = {"sweep_seconds": main["seconds"] / sweeps, "in_core_sweep_seconds":
               in_core_bench_s / sweeps, "split_per_sweep": per_sweep, "gap_to_in_core": gaps,
               "gap_after_one_sweep": first_gaps, "loss_rel_to_in_core": loss_rel,
               "gap_to_in_core_f64": gaps64,
               "gap_at_bench_budgets": bench_gaps,
               "chunk_loads_a_sweep": main["result"].chunk_loads / sweeps,
               "duhl": {k: {"sweeps": r["result"].sweeps, "chunk_loads": r["result"].chunk_loads,
                            "seconds": r["seconds"], "cache_bytes": r["cache_bytes"],
                            "loss": r["result"].losses[-1]} for k, r in duhl_runs.items()}}
    return {"fused_glm": dict(check, launches=launches["fused_glm"], summary=summary,
                              chunk_shape=check["shape"]),
            "fused_glm_reduce": dict(reduce, launches=launches["fused_glm_reduce"]),
            "packed_glm": dict(packed, launches=packed_launches, in_core_comparison_fit=True),
            "packed_glm_reduce": dict(packed_red, launches=packed_reduce)}, one_rank


def _sg_avro(np, seed: int, base: Path) -> dict:
    """The flagship's rows of its first users (phase 8's generator and
    seed), user-clustered in two part files, and held-out rows of the same
    model in one: ``STREAM_GAME["avro_rows"]`` training rows."""
    cfg = STREAM_GAME
    shape = dict(GAME["flagship"], d_fe=GAME["flagship"]["d_fe"] - 1,
                 held_out=cfg["avro_validation_rows"])
    train, held = _game_arrays(np, seed + 12, **shape)
    order = np.argsort(train["keys"]["user"], kind="stable")[:cfg["avro_rows"]]
    sub = {"x_fe": train["x_fe"][order], "x_re": train["x_re"][order],
           "keys": {t: k[order] for t, k in train["keys"].items()},
           "labels": {t: v[order] for t, v in train["labels"].items()}}
    for args in _game_parts(sub, base / "train", 0, 2, cluster=True) \
            + _game_parts(held, base / "validation", len(order), 1):
        _write_game_part(args)
    return {"train": base / "train", "validation": base / "validation", "rows": len(order),
            "users": len(np.unique(sub["keys"]["user"]))}


def _sg_shard_configs():
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration

    return {"global": FeatureShardConfiguration(feature_bags=("features",), has_intercept=True),
            "per_entity": FeatureShardConfiguration(feature_bags=("perEntityFeatures",),
                                                    has_intercept=False)}


class _SgKiller:
    """An exchange that raises a transient preemption on ``rank`` at its
    first operation whose tag contains ``tag`` (withheld from the store) or,
    with ``fatal``, a sticky CUDA error; the coordinator's calls pass
    through. ``fired_at`` is the failure's wall time."""

    def __init__(self, inner, tag: str, rank: int, fatal: bool = False):
        self._inner, self._tag, self._target, self._fatal = inner, tag, rank, fatal
        self.fired = 0
        self.fired_at = None

    rank = property(lambda self: self._inner.rank)
    num_ranks = property(lambda self: self._inner.num_ranks)
    generation = property(lambda self: self._inner.generation)

    def set_generation(self, generation):
        self._inner.set_generation(generation)

    def fence_namespace(self):
        return self._inner.fence_namespace()

    def post_abort(self, info):
        self._inner.post_abort(info)

    def pending_abort(self):
        return self._inner.pending_abort()

    def _maybe_die(self, tag):
        if self._inner.rank == self._target and self._tag in tag and not self.fired:
            self.fired += 1
            self.fired_at = time.time()
            if self._fatal:
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            raise RuntimeError("UNAVAILABLE: worker preempted by the pool scheduler; "
                               "Socket closed")

    def allgather(self, tag, payload):
        self._maybe_die(tag)
        return self._inner.allgather(tag, payload)

    def barrier(self, tag):
        self._maybe_die(tag)
        return self._inner.barrier(tag)


class _SgJournal:
    def __init__(self):
        self.rows = []

    def record(self, kind, **fields):
        self.rows.append({"kind": kind, "time": time.time(),
                          **{k: v if isinstance(v, (int, float, str, type(None))) else str(v)
                             for k, v in fields.items()}})


def _sg_memory_rank(torch, np, rank: int, world: int, dev, job: dict) -> dict:
    """16(c) at the flagship's depth: this rank streams its contiguous run of
    the in-memory flagship's user-clustered chunks, the FE sums and the RE
    tables crossing the group's key-value exchange, at the budgets of 16(a)'s
    comparison, in f32 and in f64."""
    from photon_ml_torch.algorithm.streaming_game import StreamingGameProgram
    from photon_ml_torch.io.partitioned_reader import assign_contiguous
    from photon_ml_torch.io.stream_reader import (
        GameArrayChunkSource,
        GameStreamPartition,
        plan_entity_chunks,
    )
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.types import TaskType

    cfg = STREAM_GAME
    train, vocab, user_idx = _sg_flagship(np, job["seed"])
    plan = plan_entity_chunks(user_idx, cfg["chunk"])
    ranges = assign_contiguous([len(r) for r in plan], world)
    lo, hi = ranges[rank]
    rows = np.concatenate(plan[lo:hi])
    row_bytes = train["x_fe"].itemsize * (train["x_fe"].shape[1] + train["x_re"].shape[1])
    part = GameStreamPartition(
        rank=rank, num_ranks=world, num_chunks=len(plan),
        chunk_ranges=tuple((int(a), int(b)) for a, b in ranges),
        chunk_rows=max(len(r) for r in plan), total_records=len(user_idx),
        payload_bytes=tuple(sum(len(r) for r in plan[a:b]) * row_bytes for a, b in ranges),
        input_bytes=len(user_idx) * row_bytes, fingerprint="flagship-in-memory")
    fe, res = _sg_specs(cfg["budget_fe_iterations"], cfg["budget_re_iterations"])
    out = {"chunk_range": [int(lo), int(hi)], "num_chunks": len(plan), "rows": len(user_idx)}
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        source = GameArrayChunkSource(
            features={"global": train["x_fe"][rows].astype(dtype),
                      "per_entity": train["x_re"][rows].astype(dtype)},
            labels=train["labels"]["LOGISTIC_REGRESSION"][rows].astype(dtype),
            entity_idx={"user": user_idx[rows]}, chunk_records=cfg["chunk"], cluster_by="user")
        assert source.num_chunks == hi - lo, (source.num_chunks, lo, hi)
        ex = multihost.DistributedKVExchange(cfg["exchange_timeout_s"])
        run = _sg_run(torch, StreamingGameProgram(
            TaskType.LOGISTIC_REGRESSION, source, fe, res, num_entities={"user": len(vocab)},
            bucket_sizes=(GAME["cap"],), exchange=ex, partition=part, device=dev),
            f"two ranks, {name}", cfg["sweeps"])
        st = _sg_state(run["result"])
        out[name] = {"fe": st["fe"].tolist(), "user": st["re/user"].tolist(),
                     "losses": run["result"].losses, "seconds": run["seconds"],
                     "launches": run["launches"], "exchange": dict(ex.counts),
                     "timings": run["timings"]}
    return out


def _sg_rank_streams(torch, np, rank: int, world: int, tmp: Path, dev, job: dict) -> dict:
    """One rank of 16(c)-(d): the in-memory flagship over two ranks, the
    partitioned streamed GAME run over the Avro, the same run with rank 1
    killed at the sweep-2 commit, ``train_partitioned`` likewise, and a
    sticky CUDA error on rank 1."""
    from photon_ml_torch import convert
    from photon_ml_torch.algorithm.streaming_game import StreamingGameProgram
    from photon_ml_torch.io.checkpoint import TrainingCheckpointer
    from photon_ml_torch.io.partitioned_reader import read_partitioned
    from photon_ml_torch.io.stream_reader import plan_partitioned_game_stream
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh
    from photon_ml_torch.resilience import (
        CoordinatedRecovery,
        ExchangeTimeout,
        recovery,
        run_with_recovery,
    )
    from photon_ml_torch.types import TaskType

    cfg = STREAM_GAME
    out: dict = {"memory": _sg_memory_rank(torch, np, rank, world, dev, job)}
    fe, res = _sg_specs(cfg["avro_fe_iterations"], cfg["avro_re_iterations"], re_type="userId")

    def streamed(exchange, ck=None, coordinator=None, label="plain"):
        plan_ex = exchange
        source, maps, vocabs, part = plan_partitioned_game_stream(
            job["train"], _sg_shard_configs(), ("userId",), exchange=plan_ex,
            chunk_records=cfg["avro_chunk"], cluster_by="userId")
        program = StreamingGameProgram(TaskType.LOGISTIC_REGRESSION, source, fe, res,
                                       num_entities={"userId": len(vocabs["userId"])},
                                       exchange=exchange, partition=part, device=dev)
        marks = []
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        _reset_stream_counts()
        sync()
        t0 = time.perf_counter()
        result = program.train(num_sweeps=cfg["avro_sweeps"], checkpointer=ck,
                               resume_step=None if coordinator is None
                               else coordinator.resume_step,
                               on_sweep=lambda s, n, loss: marks.append(time.time()))
        sync()
        return {"result": result, "seconds": time.perf_counter() - t0, "sweep_ends": marks,
                "launches": _stream_counts(), "partition": part, "timings": program.timings,
                "started": t0}

    # (c) the plain run over the group's key-value exchange
    ex = multihost.DistributedKVExchange(cfg["exchange_timeout_s"])
    plain = streamed(ex)
    st = plain["result"].state
    part = plain["partition"]
    out["plain"] = {"fe": st.fe_coefficients.double().cpu().tolist(),
                    "user": st.re_tables["userId"].double().cpu().tolist(),
                    "losses": plain["result"].losses, "seconds": plain["seconds"],
                    "launches": plain["launches"], "exchange": dict(ex.counts),
                    "chunk_range": list(part.chunk_range()), "num_chunks": part.num_chunks,
                    "payload_bytes": part.payload_bytes[rank], "input_bytes": part.input_bytes,
                    "timings": plain["timings"], "fingerprint": part.fingerprint}
    # (d) rank 1 killed at the sweep-2 commit barrier, coordinated recovery
    fenced = multihost.DistributedKVExchange(cfg["exchange_timeout_s"])
    killer = _SgKiller(fenced, "checkpoint_commit/2/ready", 1)
    ck = TrainingCheckpointer(tmp / "streamed-ck")
    journal = _SgJournal()
    coord = CoordinatedRecovery(killer, max_restarts=2, checkpointer=ck, journal=journal)
    attempts = []

    def attempt(restart):
        attempts.append(time.time())
        return streamed(killer, ck, coord, label=f"attempt {restart}")

    recovery.reset_counts()
    killed = run_with_recovery(attempt, checkpointer=ck, journal=journal, coordinator=coord,
                               description=f"streamed rank {rank}")
    ks = killed["result"].state
    aborts = [r for r in journal.rows if r["kind"] == "peer_abort"]
    restarts = [r for r in journal.rows if r["kind"] == "coordinated_restart"]
    out["killed"] = {"fe": ks.fe_coefficients.double().cpu().tolist(),
                     "user": ks.re_tables["userId"].double().cpu().tolist(),
                     "losses": killed["result"].losses, "fired": killer.fired,
                     "fired_at": killer.fired_at, "attempts": attempts,
                     "first_resumed_sweep_end": (killed["sweep_ends"] or [None])[0],
                     "resume_step": coord.resume_step, "generation": coord.generation,
                     "peer_abort_origin": aborts[0]["origin_rank"] if aborts else None,
                     "restart_origin": restarts[0]["origin_rank"] if restarts else None,
                     "checkpoint_bytes": ck.last_save["bytes"] if ck.last_save else None,
                     "checkpoint_seconds": ck.last_save["seconds"] if ck.last_save else None,
                     "restores": recovery.counts["checkpoint_restores"]}

    # (d) train_partitioned (phase 13's fused program, FE + per-user) likewise
    mesh = make_mesh()
    pex = multihost.DistributedKVExchange(cfg["exchange_timeout_s"])
    partr = read_partitioned(job["train"], _sg_shard_configs(), exchange=pex,
                             random_effect_id_columns=("userId",), device=dev, tag="sg-fused")
    from photon_ml_torch.data.game_data import build_random_effect_dataset_partitioned

    re_ds = {"userId": build_random_effect_dataset_partitioned(
        partr.result.dataset, "userId", "per_entity", partition=partr.partition, exchange=pex,
        bucket_sizes=(GAME["cap"],), entity_rank_presence=partr.entity_rank_presence.get(
            "userId"))}
    parts = {rank: (partr.result.dataset, re_ds)}

    def fused(exchange, ck_=None, coordinator=None):
        program = _fused_program(k=None, re_types=("userId",), mesh=mesh)
        return dist.train_partitioned(program, parts, mesh, world, num_iterations=3,
                                      exchange=exchange, checkpointer=ck_,
                                      resume_step=None if coordinator is None
                                      else coordinator.resume_step), program

    ref, ref_prog = fused(pex)
    fenced2 = multihost.DistributedKVExchange(cfg["exchange_timeout_s"])
    killer2 = _SgKiller(fenced2, "checkpoint_commit/2/ready", 1)
    ck2 = TrainingCheckpointer(tmp / "fused-ck")
    journal2 = _SgJournal()
    coord2 = CoordinatedRecovery(killer2, max_restarts=2, checkpointer=ck2, journal=journal2)
    fused_attempts = []

    def fused_attempt(restart):
        fused_attempts.append(time.time())
        return fused(killer2, ck2, coord2)

    got, got_prog = run_with_recovery(fused_attempt, checkpointer=ck2, journal=journal2,
                                      coordinator=coord2, description=f"fused rank {rank}")
    fa = _flat_state(convert.train_state_to_numpy(ref_prog.whole_state(ref.state)))
    fb = _flat_state(convert.train_state_to_numpy(got_prog.whole_state(got.state)))
    aborts2 = [r for r in journal2.rows if r["kind"] == "peer_abort"]
    out["fused"] = {"bitwise": bool(all(np.array_equal(fa[k], fb[k]) for k in fa)
                                    and ref.losses == got.losses),
                    "fired": killer2.fired, "fired_at": killer2.fired_at,
                    "attempts": fused_attempts, "resume_step": coord2.resume_step,
                    "peer_abort_origin": aborts2[0]["origin_rank"] if aborts2 else None}

    # a sticky CUDA error on rank 1 at its first sweep's commit: fatal, so no
    # rank retries (rank 0's waits end at the exchange's deadline)
    short = multihost.DistributedKVExchange(cfg["fatal_timeout_s"])
    killer3 = _SgKiller(short, "checkpoint_commit/1/ready", 1, fatal=True)
    coord3 = CoordinatedRecovery(killer3, max_restarts=2,
                                 checkpointer=TrainingCheckpointer(tmp / "fatal-ck"))
    fatal_attempts = []

    def fatal_attempt(restart):
        fatal_attempts.append(restart)
        return streamed(killer3, coord3.checkpointer, coord3)

    recovery.reset_counts()
    try:
        run_with_recovery(fatal_attempt, checkpointer=coord3.checkpointer, coordinator=coord3,
                          description=f"fatal rank {rank}")
        fatal_error = None
    except (RuntimeError, ExchangeTimeout) as e:
        fatal_error = f"{type(e).__name__}: {e}"[:300]
    out["fatal"] = {"attempts": fatal_attempts, "error": fatal_error,
                    "retries": recovery.counts["retries"]}
    return out


def _sg_rank_main(rank: int, world: int, tmp: str, device_type: str, device_index: int,
                  job: dict) -> None:
    """One rank of 16(c)-(d) in a gloo group on the card (each rank its own
    CUDA context); writes ``tmp/rank<r>.json``. A module function, so a
    spawned process runs it."""
    import datetime

    import numpy as np
    import torch

    from photon_ml_torch.parallel import multihost

    try:
        dev = torch.device(device_type, device_index)
        multihost.initialize(f"file://{tmp}/rendezvous", world, rank, local_rank=device_index,
                             device=dev, backend="gloo",
                             timeout=datetime.timedelta(seconds=STREAM_GAME["rank_timeout_s"]))
        out = _sg_rank_streams(torch, np, rank, world, Path(tmp), dev, job)
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out, default=float))
    finally:
        multihost.shutdown()


def _stream_game_ranks(torch, np, seed: int, dev, card: str, tmp: Path, avro_in: dict,
                       one_rank: dict) -> dict:
    """16(c)-(d): two ranks sharing the card (gloo, a CUDA context each),
    over the in-memory flagship (against 16(a)'s one-rank runs,
    ``one_rank``) and over the Avro's agreed partitioned plan (against one
    rank's streamed run); the kills and their recoveries."""
    from photon_ml_torch.algorithm.streaming_game import StreamingGameProgram
    from photon_ml_torch.io import avro
    from photon_ml_torch.io.stream_reader import GameAvroChunkSource, scan_game_stream
    from photon_ml_torch.types import TaskType

    cfg = STREAM_GAME
    files = avro.list_avro_files(avro_in["train"])
    t0 = time.perf_counter()
    maps, vocabs, keys, indexes, scalars = scan_game_stream(
        files, _sg_shard_configs(), ("userId",), cluster_by="userId")
    scan_s = time.perf_counter() - t0
    source = GameAvroChunkSource(files, _sg_shard_configs(), maps,
                                 chunk_records=cfg["avro_chunk"],
                                 random_effect_id_columns=("userId",), entity_vocabs=vocabs,
                                 cluster_by="userId", cluster_keys=keys, indexes=indexes)
    fe, res = _sg_specs(cfg["avro_fe_iterations"], cfg["avro_re_iterations"], re_type="userId")
    one = _sg_run(torch, StreamingGameProgram(
        TaskType.LOGISTIC_REGRESSION, source, fe, res, scalars=scalars, device=dev),
        "one rank", cfg["avro_sweeps"])
    decode_rate = source.total_records * one["timings"]["fe_epochs"] / max(
        one["timings"]["fe_decode"], 1e-9)
    _log(f"16c. one rank streamed over the Avro ({avro_in['rows']} rows, {avro_in['users']} "
         f"users, {source.num_chunks} chunks) ({card}): {one['seconds']:.2f} s for "
         f"{cfg['avro_sweeps']} sweeps (scan {scan_s:.2f} s), stream decode {decode_rate:.0f} "
         f"records/s in the FE epochs (Python codec)")
    job = {"train": str(avro_in["train"]), "seed": seed}
    rtmp = tmp / "ranks"
    rtmp.mkdir(parents=True, exist_ok=True)
    ctx = _processes()
    procs = [ctx.Process(target=_sg_rank_main, args=(r, 2, str(rtmp), dev.type, 0, job))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(cfg["rank_timeout_s"])
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(30)
    assert not alive, f"16c: {len(alive)} ranks still running"
    assert all(p.exitcode == 0 for p in procs), ("16c", [p.exitcode for p in procs])
    ranks_s = time.perf_counter() - t0
    outs = [json.loads((rtmp / f"rank{r}.json").read_text()) for r in range(2)]
    # the flagship's depth: both ranks bitwise equal; f64 within 1e-4·max|w|
    # of one rank's run on both arrays, f32 on the fixed effect and the
    # losses (a warm-started f32 lane decides at the objective's resolution,
    # where two summation orders part: 16(a))
    mem = [o["memory"] for o in outs]
    mem_gaps, mem_loss_rel = {}, {}
    for name in ("f32", "f64"):
        a, b = mem[0][name], mem[1][name]
        assert a["fe"] == b["fe"] and a["user"] == b["user"] and a["losses"] == b["losses"], name
        mem_gaps[name] = _sg_gap(
            {"fe": torch.tensor(a["fe"], dtype=torch.float64),
             "re/user": torch.tensor(a["user"], dtype=torch.float64)},
            {k: torch.tensor(v, dtype=torch.float64) for k, v in one_rank[name].items()})
        mem_loss_rel[name] = max(abs(x - y) / abs(y) for x, y in
                                 zip(a["losses"], one_rank["losses"][name]))
    assert all(g <= 1e-4 for g in mem_gaps["f64"].values()) and mem_gaps["f32"]["fe"] <= 1e-4, \
        mem_gaps
    assert max(mem_loss_rel.values()) <= 1e-6, mem_loss_rel
    msweeps = cfg["sweeps"]
    mex = mem[0]["f32"]["exchange"]
    _log(f"16c. two ranks sharing the card over the in-memory flagship ({mem[0]['rows']} rows, "
         f"chunks {[m['chunk_range'] for m in mem]} of {mem[0]['num_chunks']}), {msweeps} "
         f"sweeps at 16(a)'s comparison budgets ({card}): both ranks bitwise equal; max |dw| / max|w| "
         f"against one rank " + json.dumps(mem_gaps) + ", losses " + json.dumps(mem_loss_rel)
         + f" rel apart; f32 {[round(m['f32']['seconds'], 3) for m in mem]} s a rank against "
         f"one rank's {one_rank['seconds']['f32']:.3f} s (its repeat "
         f"{one_rank['seconds']['f32_repeat']:.3f} s; each rank's f32 run is its process's "
         f"first), f64 "
         f"{[round(m['f64']['seconds'], 3) for m in mem]} s against "
         f"{one_rank['seconds']['f64']:.3f} s; exchange a sweep (f32, rank 0) "
         f"{mex['allgathers'] / msweeps:.1f} allgathers, {mex['bytes_sent'] / msweeps:.0f} "
         f"bytes sent and {mex['bytes_received'] / msweeps:.0f} read; rank 0's split a sweep "
         + json.dumps({k: round(v / msweeps, 6) for k, v in mem[0]["f32"]["timings"].items()})
         + f"; B1 launches a rank {[m['f32']['launches']['fused_glm'] for m in mem]} (f32)")
    # both ranks' global state bitwise equal, within 1e-4·max|w| of one rank's
    one_state = _sg_state(one["result"])
    for key in ("plain", "killed"):
        a, b = outs[0][key], outs[1][key]
        assert a["fe"] == b["fe"] and a["user"] == b["user"] and a["losses"] == b["losses"], key
    two = {"fe": torch.tensor(outs[0]["plain"]["fe"], dtype=torch.float64),
           "re/userId": torch.tensor(outs[0]["plain"]["user"], dtype=torch.float64)}
    gaps = _sg_gap(two, one_state)
    assert all(g <= 1e-4 for g in gaps.values()), gaps
    ex = outs[0]["plain"]["exchange"]
    sweeps = cfg["avro_sweeps"]
    _log(f"16c. two ranks sharing the card over gloo and the key-value exchange ({card}): "
         f"global state bitwise equal on both ranks, max |dw| / max|w| against one rank "
         + json.dumps(gaps) + f"; chunks {[o['plain']['chunk_range'] for o in outs]} of "
         f"{outs[0]['plain']['num_chunks']}, payload bytes a rank "
         f"{[o['plain']['payload_bytes'] for o in outs]} of {outs[0]['plain']['input_bytes']}; "
         f"at this toy depth, where the Python codec's decode is the time, "
         f"{[round(o['plain']['seconds'], 3) for o in outs]} s a run against one rank's "
         f"{one['seconds']:.3f}; exchange a sweep {ex['allgathers'] / sweeps:.1f} allgathers, "
         f"{ex['bytes_sent'] / sweeps:.0f} bytes sent and {ex['bytes_received'] / sweeps:.0f} "
         f"read (rank 0, the plan's included); B1 launches a rank "
         f"{[o['plain']['launches']['fused_glm'] for o in outs]}; the rank job {ranks_s:.1f} s")
    # the kill at the sweep-2 commit
    k0, k1 = outs[0]["killed"], outs[1]["killed"]
    assert k1["fired"] == 1 and k0["fired"] == 0
    for k in (k0, k1):
        assert k["fe"] == outs[0]["plain"]["fe"] and k["user"] == outs[0]["plain"]["user"] \
            and k["losses"] == outs[0]["plain"]["losses"], "the recovered run differs"
        assert k["resume_step"] == 1 and k["restart_origin"] == 1, k
    assert k0["peer_abort_origin"] == 1, k0
    fault = k1["fired_at"]
    restart_s = [k["attempts"][-1] - fault for k in (k0, k1)]
    resumed_sweep_s = [k["first_resumed_sweep_end"] - fault for k in (k0, k1)]
    f0, f1 = outs[0]["fused"], outs[1]["fused"]
    assert f0["bitwise"] and f1["bitwise"] and f1["fired"] == 1 and f0["peer_abort_origin"] == 1
    assert f0["resume_step"] == f1["resume_step"] == 1
    fused_restart_s = [f["attempts"][-1] - f1["fired_at"] for f in (f0, f1)]
    for o in outs:
        assert o["fatal"]["attempts"] == [0] and o["fatal"]["retries"] == 0, o["fatal"]
    _log(f"16d. rank 1 killed at the sweep-2 commit barrier ({card}): both ranks rolled back "
         f"to step 1 and ended bitwise the uninterrupted run, rank 0's PeerAbort names rank 1; "
         f"seconds from the fault to the restarted attempt {[round(s, 3) for s in restart_s]}, "
         f"to the end of the resumed sweep {[round(s, 3) for s in resumed_sweep_s]}; checkpoint "
         f"{k0['checkpoint_bytes']} bytes in {k0['checkpoint_seconds'] * 1e3:.2f} ms. "
         f"train_partitioned likewise: bitwise, rolled back to step 1, restart "
         f"{[round(s, 3) for s in fused_restart_s]} s. A sticky CUDA error on rank 1: one "
         f"attempt on each rank, no retry (rank 0: {outs[0]['fatal']['error']})")
    return {"memory": {"seconds": {k: [m[k]["seconds"] for m in mem] for k in ("f32", "f64")},
                       "one_rank_seconds": one_rank["seconds"], "gap_to_one_rank": mem_gaps,
                       "loss_rel_to_one_rank": mem_loss_rel,
                       "exchange_a_sweep": {k: v / msweeps for k, v in mex.items()}},
            "avro_toy_depth": {"one_rank_seconds": one["seconds"],
                               "two_rank_seconds": [o["plain"]["seconds"] for o in outs],
                               "exchange_a_sweep": {k: v / sweeps for k, v in ex.items()}},
            "gap_to_one_rank": gaps,
            "restart_seconds": restart_s, "resumed_sweep_seconds": resumed_sweep_s,
            "fused_restart_seconds": fused_restart_s,
            "checkpoint": [k0["checkpoint_bytes"], k0["checkpoint_seconds"]],
            "decode_records_per_s": decode_rate,
            "launches": {k: one["launches"][k] for k in ("fused_glm", "fused_glm_reduce")}}


def _stream_game_drivers(torch, np, seed: int, dev, card: str, tmp: Path, avro_in: dict) -> dict:
    """16(e): the GAME training driver with --streaming-chunks, again with
    --duhl-working-set, and in core on the same coordinates; the streamed
    validation scores against the in-core scoring."""
    from photon_ml_torch.algorithm.streaming_game import score_game_stream
    from photon_ml_torch.cli import game_training_driver
    from photon_ml_torch.io import avro
    from photon_ml_torch.io.data_reader import read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model
    from photon_ml_torch.io.stream_reader import GameAvroChunkSource
    from photon_ml_torch.parallel.distributed import GameTrainState
    from photon_ml_torch.types import TaskType

    cfg = STREAM_GAME
    shards = ["--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
              "--feature-shard-configurations",
              "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]

    def run(out, *extra, validation=True):
        _reset_stream_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        held = ["--validation-data-path", str(avro_in["validation"]), "--evaluators", "AUC"]
        summary = game_training_driver.main([
            "--input-data-path", str(avro_in["train"]), *(held if validation else []),
            "--root-output-dir", str(tmp / out),
            "--task-type", "LOGISTIC_REGRESSION", *shards, "--coordinate-configurations",
            f"name=fixed,feature.shard=global,reg.weights=1,max.iter={cfg['avro_fe_iterations']},"
            "tolerance=0", "--coordinate-configurations",
            f"name=per_user,feature.shard=per_entity,random.effect.type=userId,reg.weights=1,"
            f"max.iter={cfg['avro_re_iterations']},tolerance=0",
            "--coordinate-descent-iterations", str(cfg["driver_sweeps"]), *extra], device=dev)
        torch.cuda.synchronize()
        return summary, time.perf_counter() - t0, _stream_counts()

    chunks = ("--streaming-chunks", str(cfg["avro_chunk"]))
    streamed, streamed_s, streamed_launches = run("streamed", *chunks)
    duhl, duhl_s, duhl_launches = run("duhl", *chunks, "--duhl-working-set",
                                      str(cfg["avro_duhl_working_set"]), "--duhl-tail-chunks", "1")
    # in core without validation data: its saved model is the last one, as
    # the streamed path's is (with validation the in-core driver keeps the
    # update with the best metric)
    in_core, in_core_s, _ = run("in-core", validation=False)

    def coefficients(root):
        maps = IndexMap.load_directory(str(tmp / root / "index-maps"))
        model = load_game_model(str(tmp / root / "best"), maps, device=dev)
        return model, maps, {"fe": model.models["fixed"].glm.coefficients.means.double().cpu(),
                             "re/user": model.models["per_user"].coefficients.double().cpu()}

    _, _, want = coefficients("in-core")
    gaps = {name: _sg_gap(coefficients(name)[2], want) for name in ("streamed", "duhl")}
    assert all(g <= 1e-3 for g in gaps["streamed"].values()), gaps
    # DuHL leaves its cold chunks' entities unsolved after the warm-up
    # sweeps, by design: its fixed effect is held to the driver bound, its
    # loss to the JAX package's DuHL bound against uniform (5e-3)
    duhl_loss_gap = abs(duhl["losses"][-1] - streamed["losses"][-1])
    assert gaps["duhl"]["fe"] <= 1e-3 and duhl_loss_gap < 5e-3, (gaps, duhl_loss_gap)
    # the streamed model's validation scores against the in-core scoring
    model, maps, w = coefficients("streamed")
    state = GameTrainState(fe_coefficients=model.models["fixed"].glm.coefficients.means,
                           re_tables={"userId": model.models["per_user"].coefficients})
    vocab = model.models["per_user"].entity_keys
    val = GameAvroChunkSource(avro.list_avro_files(avro_in["validation"]), _sg_shard_configs(),
                              maps, chunk_records=cfg["avro_chunk"],
                              random_effect_id_columns=("userId",),
                              entity_vocabs={"userId": np.asarray(vocab)})
    scores = score_game_stream(state, val, TaskType.LOGISTIC_REGRESSION, "global",
                               {"userId": "per_entity"})
    full = read_merged(str(avro_in["validation"]), _sg_shard_configs(), index_maps=maps,
                       random_effect_id_columns=("userId",),
                       entity_vocabs={"userId": np.asarray(vocab)}, device=dev).dataset
    in_core_scores = (model.score_dataset(full) + full.offsets).double().cpu().numpy()
    score_rel = float(np.abs(scores - in_core_scores).max()) / float(
        np.abs(in_core_scores).max())
    assert score_rel <= 1e-5, score_rel
    _log(f"16e. GAME driver on the Avro ({avro_in['rows']} rows) ({card}): --streaming-chunks "
         f"{cfg['avro_chunk']} {streamed_s:.2f} s ({streamed['streaming']['chunks']} chunks, "
         f"{streamed['streaming']['chunk_loads']} loads), --duhl-working-set "
         f"{cfg['avro_duhl_working_set']} {duhl_s:.2f} s "
         f"({duhl['streaming']['chunk_loads']} loads, {duhl['streaming']['chunk_visits']} of "
         f"{streamed['streaming']['chunk_visits']} RE chunk visits, final loss "
         f"{duhl_loss_gap:.3g} from uniform's), in core {in_core_s:.2f} s; coefficients "
         f"against the in-core run, max |dw| / max|w|: " + json.dumps(gaps) + f"; streamed "
         f"validation AUC {streamed['best_metric']:.6f} (DuHL {duhl['best_metric']:.6f}); "
         f"score_game_stream against the in-core scoring {score_rel:.3g} rel; B1 launches "
         f"{streamed_launches['fused_glm']} streamed, {duhl_launches['fused_glm']} DuHL")
    return {"gaps": gaps, "score_rel": score_rel,
            "seconds": {"streamed": streamed_s, "duhl": duhl_s, "in_core": in_core_s},
            "launches": {k: streamed_launches[k] + duhl_launches[k]
                         for k in ("fused_glm", "fused_glm_reduce")}}


def _stream_game_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 16: streamed GAME, two ranks and coordinated recovery, printing
    as it goes. Returns, for each kernel this path runs, its launches here
    and its checks on the path's own inputs (B1 on a GAME chunk, the packed
    kernel on the in-core comparison fit)."""
    t_phase = time.perf_counter()
    base = Path(tempfile.mkdtemp(prefix="stream-game-",
                                 dir=Path(__file__).resolve().parent / "build"))
    try:
        times = {}
        t0 = time.perf_counter()
        path, one_rank = _stream_game_memory(torch, np, seed, dev, card)
        times["ab"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        avro_in = _sg_avro(np, seed, base / "avro")
        times["write"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = _stream_game_ranks(torch, np, seed, dev, card, base, avro_in, one_rank)
        times["cd"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        drivers = _stream_game_drivers(torch, np, seed, dev, card, base, avro_in)
        times["e"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    for name in ("fused_glm", "fused_glm_reduce"):
        path[name]["launches"] += ranks["launches"][name] + drivers["launches"][name]
        path[name]["one_rank_avro"] = ranks["launches"][name]
        path[name]["driver"] = drivers["launches"][name]
    path["fused_glm"]["ranks"] = {k: v for k, v in ranks.items() if k != "launches"}
    path["fused_glm"]["drivers"] = {k: v for k, v in drivers.items() if k != "launches"}
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    seconds = time.perf_counter() - t_phase
    path["fused_glm"]["phase_seconds"] = seconds
    _log(f"16. stream GAME phase ({card}): {seconds:.2f} s (a-b {times['ab']:.2f}, Avro "
         f"{times['write']:.2f}, c-d {times['cd']:.2f}, e {times['e']:.2f})")
    return path


#: phase 17's cells: the held-out rows of phase 11's flagship (a fixed effect
#: on ``global`` d = 256, per-user and per-item d = 16 over 2000 users and 1500
#: items, a user × item MF of k = 16; 2^15 rows, a quarter of unseen users) and
#: of phase 9's sparse GAME model (a fixed effect over d = 10^6 Zipf columns,
#: 16 a row, and a compact per-user effect on the same shard; 2^14 rows, and
#: ``long_requests`` more rows of ``long_nnz`` distinct columns each, a request
#: longer than two gather chunks) served one row a request through the
#: micro-batching server on shapes (64, 256, 1024). The flagship trains
#: ``sweeps`` fused sweeps and its refresh one more; the sparse model one
#: ``GameEstimator`` sweep (fit a's ELL and fit b's hybrid layouts).
#: ``baseline_requests``: the one-request-a-micro-batch baseline's length.
SERVING = dict(shapes=(64, 256, 1024), sweeps=2, baseline_requests=4096, max_wait_ms=2.0,
               long_requests=32, long_nnz=4096, hybrid_requests=4096, driver_request_rows=4)


def _serve_replay(torch, np, scorer, requests, *, swap=None, swap_at=None,
                  sequential: bool = False) -> dict:
    """A closed-loop replay through ``MicroBatchServer`` (``SERVING``'s
    ``max_wait_ms``): every request submitted as the bounded queue admits
    it and every future resolved; ``sequential``: each request submitted
    once the one before it resolved (a micro-batch each). With ``swap``: the
    first ``swap_at`` requests resolve, then ``swap`` is hot-swapped in and
    the rest follow. Returns the scores a request, seconds, scores/s,
    latency p50/p95, the pad fraction, micro-batches and the captures the
    replay made."""
    from photon_ml_torch.serving import MicroBatchServer
    from photon_ml_torch.telemetry import serving_counters

    serving_counters.reset_serving_metrics()
    captures = scorer.captures
    futures = []
    t0 = time.perf_counter()
    with MicroBatchServer(scorer, max_wait_ms=SERVING["max_wait_ms"]) as server:
        for i, r in enumerate(requests):
            if swap is not None and i == swap_at:
                for f in futures:
                    f.result(120)
                server.swap_model(swap)
            futures.append(server.submit(r))
            if sequential:
                futures[-1].result(120)
        scores = [f.result(120) for f in futures]
    seconds = time.perf_counter() - t0
    rows = sum(len(s) for s in scores)
    latency = serving_counters.latency_summary()
    reg = serving_counters.default_registry()
    return {"scores": scores, "requests": len(requests), "rows": rows, "seconds": seconds,
            "scores_per_s": rows / seconds, "latency_ms_p50": latency["p50"],
            "latency_ms_p95": latency["p95"], "pad_fraction": serving_counters.pad_fraction(),
            "micro_batches": reg.counter(serving_counters.BATCHES).value,
            "captures": scorer.captures - captures}


def _unbatched_rate(scorer, requests) -> float:
    """Scores/s of one request a micro-batch (no queue), the same run's
    baseline."""
    t0 = time.perf_counter()
    rows = sum(len(scorer.score(r)) for r in requests)
    return rows / (time.perf_counter() - t0)


def _plain_program(torch, inner, layouts, inputs: dict, params: dict, bucket: int,
                   counts: dict):
    """The resident program's plain version on the CPU in f64 (every gather
    the plain ``index_add_``), and the same over magnitudes: (scores, each
    row's Σ|terms|)."""
    def host(t, mag=False):
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.double()
            return t.abs() if mag else t
        return t

    out = []
    for mag in (False, True):
        ins = {k: host(v, mag) for k, v in inputs.items()}
        ps = {cid: {k: host(v, mag) for k, v in p.items()} for cid, p in params.items()}
        out.append(inner.score_resident(layouts, ins, ps, bucket, counts))
    return out


def _graph_checks(torch, np, scorer, tag: str) -> tuple[list, list]:
    """Inside the captured path, on each signature's own padded inputs (the
    static buffers, holding its last micro-batch): the graph replayed twice
    (bitwise equal) against the plain program in f64 (per row |g − p| <=
    1e-5·Σ|terms|); and each gather the graph holds, G1's row or segment
    kernel over a sparse fixed effect's entries and over a compact effect's
    flat slots, called on those inputs by :func:`_gather_check` (twice
    bitwise, f64 plain version, 1e-5·Σ|v·w| a row). Returns (graph checks,
    gather checks)."""
    from photon_ml_torch.ops import sparse_gather

    inner = scorer._scorer
    graphs, gathers = [], []
    for (bucket, layouts_key, entry_sig), g in sorted(scorer._graphs.items(),
                                                      key=lambda kv: str(kv[0])):
        keyed = dict(layouts_key)
        layouts = {cid: keyed[cid] for cid in inner.model.models if cid in keyed}
        counts = {cid: c for cid, _, _, c in entry_sig}
        g.graph.replay()
        first = g.out.clone()
        g.graph.replay()
        second = g.out.clone()
        torch.cuda.synchronize()
        assert torch.equal(first, second), f"{tag}: a replay is not bitwise repeatable"
        params = inner.resident_params(layouts, bf16=scorer.bf16)
        plain, scale = _plain_program(torch, inner, layouts, g.inputs, params, bucket, counts)
        err = (first.detach().cpu().double() - plain).abs()
        bad = int((err > 1e-5 * scale + 1e-30).sum())
        assert bad == 0, f"{tag}: graph {bucket, entry_sig} off its plain program in {bad} rows"
        graphs.append({"bucket": bucket, "entry_axes": [list(e) for e in entry_sig],
                       "max_err_over_scale": float((err / (scale + 1e-30)).max()),
                       "replay_ms": _eager_ms(torch, g.graph.replay)})
        for cid, target, long_rows, count in entry_sig:
            arg = lambda name: g.inputs[f"{cid}/{name}"]  # noqa: E731
            chunks = sparse_gather.ChunkPlan(arg("chunk_rows"), arg("chunk_ptr"), count) \
                if count else None
            w = params[cid]["w"] if layouts[cid] == "sparse" else \
                params[cid]["table_ext"].reshape(-1)
            check = _gather_check(torch, f"{tag}: {cid} ({layouts[cid]}) in the {bucket}-row "
                                  f"graph, {target} entries", w, bucket,
                                  tail=(arg("vals"), arg("cols"), arg("rows"), arg("row_ptr")),
                                  chunks=chunks)
            kernel = "rows" if target >= sparse_gather.SHORT_ROWS * bucket else "segments"
            gathers.append(dict(check, layout=layouts[cid], kernel=kernel, chunks=count,
                                chunk_rows=long_rows))
    return graphs, gathers


def _serving_flagship(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 17 (a), (c), (d): the flagship served, hot-swapped and in bf16."""
    import copy

    from photon_ml_torch.algorithm.mf_coordinate import build_mf_dataset
    from photon_ml_torch.data.game_data import (
        build_random_effect_dataset,
        concat_game_datasets,
        pad_game_dataset_to,
        slice_game_dataset,
    )
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel.scoring import DistributedScorer
    from photon_ml_torch.serving import ModelSwapError, ResidentScorer

    shape = FUSED["flagship"]
    shapes = SERVING["shapes"]
    t0 = time.perf_counter()
    train, held = _game_arrays(np, seed + 20, **shape)
    task = "LOGISTIC_REGRESSION"
    ds = _game_dataset(train, task, dev)
    held_dev = _game_dataset(held, task, dev, vocabs=ds.entity_vocabs)
    # requests arrive in host memory: their datasets live on the CPU
    held_host = _game_dataset(held, task, torch.device("cpu"), vocabs=ds.entity_vocabs)
    del train, held
    re_ds = {t: build_random_effect_dataset(ds, t, "per_entity", bucket_sizes=(GAME["cap"],))
             for t in ("user", "item")}
    mf_ds = {"mf": build_mf_dataset(ds, "user", "item")}
    program = _fused_program(k=shape["k"], alternations=shape["alternations"],
                             mf_l2=shape["mf_l2"])
    result = dist.train_distributed(program, ds, re_ds, mf_datasets=mf_ds,
                                    num_iterations=SERVING["sweeps"])
    old = copy.deepcopy(dist.state_to_game_model(program, result.state, ds, re_datasets=re_ds))
    refreshed = dist.train_distributed(program, ds, re_ds, mf_datasets=mf_ds, num_iterations=1,
                                       state=result.state)
    new = dist.state_to_game_model(program, refreshed.state, ds, re_datasets=re_ds)
    del ds, re_ds, mf_ds, result, refreshed
    n = held_host.num_samples
    requests = [slice_game_dataset(held_host, i, i + 1) for i in range(n)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    scorer = ResidentScorer(old, shapes=shapes)
    t0 = time.perf_counter()
    scorer.warm(requests[0])
    torch.cuda.synchronize()
    warm = {"captures": scorer.captures, "seconds": time.perf_counter() - t0}
    # each bucket's graph against score_dataset of the same padded bucket
    eager = DistributedScorer(old)
    buckets = {}
    for b in shapes:
        for m in (b // 2 + 1, b):
            got = scorer.score(slice_game_dataset(held_host, 0, m))
            padded, _ = pad_game_dataset_to(slice_game_dataset(held_dev, 0, m), b)
            assert np.array_equal(got, eager.score_dataset(padded)[:m]), \
                f"the {b}-row graph differs from score_dataset of the padded bucket"
        buckets[b] = "bitwise"
    # one graph a bucket on the card; the CPU runs the program eagerly
    assert scorer.captures == warm["captures"] == (len(shapes) if dev.type == "cuda" else 0)
    baseline = _unbatched_rate(scorer, requests[:SERVING["baseline_requests"]])
    # (c) the replay with an equal-layout swap halfway
    replay = _serve_replay(torch, np, scorer, requests, swap=new, swap_at=n // 2)
    assert replay["captures"] == 0, replay["captures"]
    served = np.concatenate(replay.pop("scores"))
    want = np.concatenate([eager.score_dataset(held_dev)[:n // 2],
                           DistributedScorer(new).score_dataset(held_dev)[n // 2:]])
    scale = float(np.abs(want).max())
    gap = float(np.abs(served - want).max())
    assert served.shape == (n,) and np.isfinite(served).all()
    assert gap <= 1e-6 * scale, (gap, scale)
    # where a full micro-batch of one-row requests spends its time (host
    # clock, synchronized): merging them, assembling the bucket's inputs,
    # the whole score (assembly, copy, replay, read); each graph's replay
    group = requests[:shapes[-1]]
    t0 = time.perf_counter()
    merged = concat_game_datasets(group)
    concat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scorer._scorer.resident_inputs(merged, shapes[-1])
    assemble_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer.score(merged)
    score_s = time.perf_counter() - t0
    breakdown = {"requests": len(group), "concat_ms": 1e3 * concat_s,
                 "assemble_ms": 1e3 * assemble_s, "score_ms": 1e3 * score_s,
                 "replay_ms": {sig[0]: _eager_ms(torch, g.graph.replay)
                               for sig, g in scorer._graphs.items()}}
    # a layout-changing swap is refused and the resident model keeps serving
    fe = new.get("global")
    wider = type(new)(models={**new.models, "global": dataclasses.replace(
        fe, glm=dataclasses.replace(fe.glm, coefficients=dataclasses.replace(
            fe.glm.coefficients, means=torch.zeros(fe.glm.coefficients.means.shape[0] + 1,
                                                   device=dev))))})
    probe = slice_game_dataset(held_host, 0, 100)
    before = scorer.score(probe)
    try:
        scorer.swap_model(wider)
    except ModelSwapError as e:
        refused = str(e).split(";")[0]
    else:
        raise AssertionError("a layout-changing swap was accepted")
    assert np.array_equal(scorer.score(probe), before) and scorer.captures == warm["captures"]
    # (d) bf16 along the whole path
    half = ResidentScorer(new, shapes=shapes, bf16=True)
    bf16 = np.concatenate([half.score(slice_game_dataset(held_host, lo, min(lo + 1024, n)))
                           for lo in range(0, n, 1024)])
    exact = want[n // 2:]
    bf16_gap = float(np.abs(bf16[n // 2:] - exact).max())
    assert np.isfinite(bf16).all() and bf16_gap <= 0.05 * scale, bf16_gap
    out = {"rows": n, "setup_seconds": setup_s, "warm": warm, "buckets_bitwise": buckets,
           "signatures": len(scorer.signatures), "unbatched_scores_per_s": baseline,
           "replay": replay, "micro_batch": breakdown,
           "swap": {"at_request": n // 2, "captures": replay["captures"],
                                      "served_gap_to_eager": gap, "max_abs_score": scale},
           "layout_swap_refused": refused, "bf16_max_gap": bf16_gap,
           "bf16_gap_over_max_score": bf16_gap / scale,
           "bf16_captures": half.captures, "resident_params_bytes":
               scorer._scorer.resident_params_bytes()}
    _log(f"17a/c/d. the flagship served ({card}): " + json.dumps(out))
    return out


def _long_requests(np, seed: int, count: int, nnz: int, d: int, users: np.ndarray, device):
    """``count`` one-row requests of ``nnz`` distinct uniform columns each
    (a row longer than two gather chunks), over phase 9's users."""
    from photon_ml_torch.data.game_data import build_game_dataset, slice_game_dataset
    from photon_ml_torch.data.sparse_batch import SparseShard

    rng = np.random.default_rng(seed + 171)
    cols = np.concatenate([rng.choice(d, size=nnz, replace=False) for _ in range(count)])
    shard = SparseShard(rows=np.repeat(np.arange(count), nnz), cols=cols,
                        vals=(rng.normal(size=count * nnz) / np.sqrt(nnz)).astype(np.float32),
                        num_samples=count, feature_dim=d)
    ds = build_game_dataset(labels=np.zeros(count, np.float32), feature_shards={"global": shard},
                            entity_keys={"user": rng.choice(users, size=count)},
                            entity_vocabs={"user": users}, device=device)
    return [slice_game_dataset(ds, i, i + 1) for i in range(count)]


def _magnitudes(model, dataset):
    """The model with every parameter's magnitude and ``dataset`` with every
    coalesced value's and offset's: scored together, each row's Σ|terms|."""
    import numpy as np

    from photon_ml_torch.data.sparse_batch import SparseShard
    from photon_ml_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel

    models = {}
    for cid, m in model.models.items():
        if isinstance(m, FixedEffectModel):
            c = m.glm.coefficients
            models[cid] = dataclasses.replace(m, glm=dataclasses.replace(
                m.glm, coefficients=dataclasses.replace(c, means=c.means.abs(), variances=None)))
        elif isinstance(m, RandomEffectModel):
            models[cid] = dataclasses.replace(m, coefficients=m.coefficients.abs(),
                                              variances=None)
        else:
            models[cid] = dataclasses.replace(m, row_factors=m.row_factors.abs(),
                                              col_factors=m.col_factors.abs())
    shards = {}
    for sid, shard in dataset.feature_shards.items():
        if isinstance(shard, SparseShard):
            rows, cols, vals = (np.asarray(a) for a in shard.coalesced())
            shards[sid] = SparseShard(rows=rows, cols=cols, vals=np.abs(vals),
                                      num_samples=shard.num_samples,
                                      feature_dim=shard.feature_dim)
        else:
            shards[sid] = shard.abs()
    kept = {k: v for k, v in dataset.host_cache.items()
            if k != "offsets" and not k.startswith("shard/")}
    mags = dataclasses.replace(dataset, feature_shards=shards, offsets=dataset.offsets.abs(),
                               host_cache=kept, _sparse_batches={})
    return GameModel(models=models), mags


def _replay_traces(torch, scorer, tag: str) -> list:
    """One replay of each captured signature under ``torch.profiler``: the
    gather kernels the trace shows by name against the launches the graph
    counts a replay (``_Graph.launches``, from its signature); they must be
    equal. A session whose trace disagrees (or records no device event) is
    taken again, up to three sessions, the later ones with CPU activity too,
    and the sessions each signature took are reported: a launch count that
    is wrong disagrees in every session, a session the profiler missed does
    not repeat. A signature no session traced is reported with ``traced``
    null."""
    from photon_ml_torch.ops import sparse_gather

    names = {"launches": "gather_rows_kernel", "segment_launches": "gather_segments_kernel",
             "chunk_launches": "gather_chunks_kernel"}
    cpu, cuda = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
    out = []
    for (bucket, _, entry_sig), g in sorted(scorer._graphs.items(), key=lambda kv: str(kv[0])):
        counted = {c: g.launches.get((sparse_gather, c), 0) for c in names}
        traced, kernels, sessions = None, [], 0
        for acts in ([cuda], [cpu, cuda], [cpu, cuda]):
            sessions += 1
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                g.graph.replay()
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if str(getattr(e, "device_type", "")).endswith("CUDA")]
            if kernels:
                traced = {c: sum(name in k for k in kernels) for c, name in names.items()}
                if traced == counted:
                    break
        assert traced is None or traced == counted, \
            f"{tag}: the {bucket}-row graph {entry_sig} ran {traced} gather kernels in a " \
            f"traced replay ({sorted(set(k[:60] for k in kernels))}), counts {counted}"
        out.append({"bucket": bucket, "entry_axes": [list(e) for e in entry_sig],
                    "traced": traced, "counted": counted, "device_events": len(kernels),
                    "sessions": sessions})
    return out


def _bucket_bitwise(torch, np, scorer, eager, host, dev_ds, b: int, m: int, tag: str) -> dict:
    """The ``b``-row graph's scores of ``m`` rows (``host``, a request on the
    CPU; ``dev_ds`` the same rows on the card) against ``score_dataset`` of
    the same rows padded by ``pad_game_dataset_to`` to ``b``: bitwise on
    every row that both programs gather with the same kernel and plan. The
    resident inputs pad each entry axis to a power of two with zeros on its
    last row, which can make that row long (a chunk plan the eager run has
    not) or move the axis to the row kernel; such rows are held to
    1e-5·Σ|terms| instead and counted."""
    from photon_ml_torch.data.game_data import pad_game_dataset_to
    from photon_ml_torch.ops import sparse_gather
    from photon_ml_torch.parallel.scoring import DistributedScorer

    got = scorer.score(host)
    padded, _ = pad_game_dataset_to(dev_ds, b)
    want = eager.score_dataset(padded)[:m]
    inputs, layouts, sig = scorer._scorer.resident_inputs(host, b)
    rows = np.asarray(host.feature_shards["global"].coalesced()[0])
    lens = np.bincount(rows, minlength=m)
    plain_long = set(np.flatnonzero(lens > sparse_gather.SEGMENT_CHUNK).tolist())
    excused = set()
    for cid, target, _, count in sig:
        if sparse_gather.tail_kernel_counter(b, target) != \
                sparse_gather.tail_kernel_counter(b, len(rows)):
            excused = set(range(m))
        elif count:
            excused |= set(inputs[f"{cid}/chunk_rows"][0].tolist()) - plain_long
    excused = {r for r in excused if r < m}
    keep = np.asarray([r not in excused for r in range(m)])
    assert np.array_equal(got[keep], want[keep]), \
        f"{tag}: the {b}-row graph differs from score_dataset of the padded bucket"
    out = {"bucket": b, "rows": m, "bitwise_rows": int(keep.sum()), "other_rows": len(excused)}
    if excused:
        mag_model, mag_ds = _magnitudes(eager.model, padded)
        scale = DistributedScorer(mag_model).score_dataset(mag_ds)[:m]
        err = np.abs(got - want)[~keep]
        assert (err <= 1e-5 * scale[~keep]).all(), (tag, b, m, err)
        out["other_rows_bitwise"] = bool((err == 0).all())
    return out


def _serving_sparse(torch, np, seed: int, dev, card: str) -> tuple[dict, dict]:
    """Phase 17 (b): phase 9's sparse GAME models served (the ELL fit and
    the hybrid fit); returns (the path, a summary)."""
    from photon_ml_torch.data.game_data import concat_game_datasets, slice_game_dataset
    from photon_ml_torch.data.sparse_batch import HybridPolicy
    from photon_ml_torch.parallel.scoring import DistributedScorer
    from photon_ml_torch.serving import ResidentScorer

    cfg = SPARSE_GAME
    shapes = SERVING["shapes"]
    t0 = time.perf_counter()
    train, held = _sparse_game_arrays(np, seed, cfg["n"], cfg["d"], cfg["per_row"],
                                      cfg["users"], cfg["held_out"])
    models = {}
    for label, lanes, policy in (("ELL", "LBFGS", None),
                                 ("hybrid", "NEWTON", HybridPolicy(hot_cols=cfg["hot_cols"]))):
        ds = _sparse_game_dataset(train, cfg["d"], dev, policy=policy)
        models[label] = (_sparse_game_estimator(lanes, 1, evaluators=()).fit(ds).model,
                         ds.entity_vocabs)
        del ds
        torch.cuda.empty_cache()
    vocabs = models["ELL"][1]
    held_host = _sparse_game_dataset(held, cfg["d"], torch.device("cpu"), vocabs=vocabs)
    held_dev = _sparse_game_dataset(held, cfg["d"], dev, vocabs=vocabs)
    n = held_host.num_samples
    requests = [slice_game_dataset(held_host, i, i + 1) for i in range(n)]
    users = np.asarray(vocabs["user"])
    longs = _long_requests(np, seed, SERVING["long_requests"], SERVING["long_nnz"], cfg["d"],
                           users, torch.device("cpu"))
    longs_dev = concat_game_datasets(_long_requests(
        np, seed, SERVING["long_requests"], SERVING["long_nnz"], cfg["d"], users, dev))
    setup_s = time.perf_counter() - t0

    _reset_gather_counts()
    runs = {}
    scorers = {}
    for label, (model, _) in models.items():
        reqs = requests if label == "ELL" else requests[:SERVING["hybrid_requests"]]
        scorer = scorers[label] = ResidentScorer(model, shapes=shapes)
        t0 = time.perf_counter()
        scorer.warm(reqs[0])
        torch.cuda.synchronize()
        warm = {"captures": scorer.captures, "seconds": time.perf_counter() - t0}
        replay = _serve_replay(torch, np, scorer, reqs)
        served = replay.pop("scores")
        runs[label] = {"warm": warm, "replay": replay}
        if label == "ELL":
            # a long request alone in its micro-batch: the row and chunk kernels
            alone = _serve_replay(torch, np, scorer, longs, sequential=True)
            served += alone.pop("scores")
            runs[label]["long_requests"] = alone
        runs[label].update(signatures=len(scorer.signatures), served=served, requests=len(reqs),
                           nnz_buckets=sorted({(sig[0], e[1]) for sig in scorer.signatures
                                               for e in sig[2] if e[0] == "fixed"}))
    launches = _gather_counts()
    torch.cuda.synchronize()
    # every served request against the eager score_dataset of the same rows,
    # unpadded (its own device assembly of the entries and plans), per row
    # within 1e-5·Σ|terms| (the eager program over magnitudes)
    gaps = {}
    for label, run in runs.items():
        model = models[label][0]
        rows = run["requests"]
        want = [DistributedScorer(model).score_dataset(slice_game_dataset(held_dev, 0, rows))]
        mag_model, mag_ds = _magnitudes(model, slice_game_dataset(held_dev, 0, rows))
        scale = [DistributedScorer(mag_model).score_dataset(mag_ds)]
        if label == "ELL":
            want.append(DistributedScorer(model).score_dataset(longs_dev))
            mag_model, mag_ds = _magnitudes(model, longs_dev)
            scale.append(DistributedScorer(mag_model).score_dataset(mag_ds))
        want, scale = np.concatenate(want), np.concatenate(scale)
        served = np.concatenate(run.pop("served"))
        assert served.shape == want.shape and np.isfinite(served).all(), label
        err = np.abs(served.astype(np.float64) - want)
        bad = int((err > 1e-5 * scale + 1e-30).sum())
        assert bad == 0, f"17b {label}: {bad} served rows off the eager scores"
        gaps[label] = {"rows": len(served), "max_abs_gap": float(err.max()),
                       "max_gap_over_scale": float((err / (scale + 1e-30)).max()),
                       "bitwise_rows": int((err == 0).sum())}
    # each bucket's graph against score_dataset of the same padded bucket,
    # and a 64-row bucket holding a long request among short ones
    buckets = {}
    for label, scorer in scorers.items():
        eager = DistributedScorer(models[label][0])
        cases = [_bucket_bitwise(torch, np, scorer, eager, slice_game_dataset(held_host, 0, m),
                                 slice_game_dataset(held_dev, 0, m), b, m, f"17b {label}")
                 for b in shapes for m in (b // 2 + 1, b)]
        mixed = concat_game_datasets([longs[0], slice_game_dataset(held_host, 0, 20)])
        mixed_dev = concat_game_datasets([slice_game_dataset(longs_dev, 0, 1),
                                          slice_game_dataset(held_dev, 0, 20)])
        cases.append(_bucket_bitwise(torch, np, scorer, eager, mixed, mixed_dev, shapes[0], 21,
                                     f"17b {label} long"))
        buckets[label] = cases
    graph_checks, gather_checks, traces = {}, [], {}
    for label, scorer in scorers.items():
        graph_checks[label], g = _graph_checks(torch, np, scorer, f"17b {label}")
        gather_checks += g
        traces[label] = _replay_traces(torch, scorer, f"17b {label}")
    chunked = [c for c in gather_checks if c["chunks"]]
    assert chunked and any(c["kernel"] == "rows" for c in gather_checks) \
        and any(c["kernel"] == "segments" for c in gather_checks), gather_checks
    traced = [dict(t, model=label) for label, ts in traces.items() for t in ts]
    fe_launches = launches["rows"] + launches["segments"] - launches["compact"]
    path = {"sparse_gather": {"launches": fe_launches, "row_kernel": launches["rows"],
                              "segment_kernel": launches["segments"],
                              "compact_scoring": launches["compact"],
                              "replay_traces": traced,
                              "checks": [c for c in gather_checks if c["layout"] == "sparse"]},
            "sparse_gather_chunks": {"launches": launches["chunks"], "checks": chunked,
                                     "replay_traces": [t for t in traced
                                                       if t["counted"]["chunk_launches"]]},
            "sparse_gather_compact": {"launches": launches["compact"],
                                      "checks": [c for c in gather_checks
                                                 if c["layout"] == "entries"]}}
    out = {"rows": n, "long_requests": len(longs), "setup_seconds": setup_s, "runs": runs,
           "served_against_eager": gaps, "buckets_against_padded_eager": buckets,
           "graphs": graph_checks, "replay_traces": traces, "launches": launches}
    _log(f"17b. the sparse GAME models served ({card}): " + json.dumps(out))
    assert launches["rows"] > 0 and launches["segments"] > 0 and launches["chunks"] > 0 \
        and launches["compact"] > 0, launches
    return path, out


def _serving_driver(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """Phase 17 (e): the serve driver on phase 8's flagship-width validation
    Avro (native decode) with ``--swap-model-dir``, serving phase 12(d)'s
    GAME driver model and swapping in its ``--distributed`` twin (trained
    here when phase 12 did not run); the resident scores of the same rows
    against the scoring driver's written scores."""
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver, serve_driver
    from photon_ml_torch.cli.configs import parse_feature_shard_config
    from photon_ml_torch.cli.game_scoring_driver import _load_scoring_model
    from photon_ml_torch.data.game_data import slice_game_dataset
    from photon_ml_torch.io.model_io import read_scores
    from photon_ml_torch.io.partitioned_reader import read_partitioned
    from photon_ml_torch.serving import ResidentScorer

    avro = _flagship_avro(np, seed, tmp)
    shards = ["--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
              "--feature-shard-configurations",
              "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
    on = None if dev.type == "cuda" else dev
    drivers = _SHARED.get("mesh_drivers")
    if drivers is None:
        drivers = tmp / "drivers"
        re_spec = "feature.shard=per_entity,reg.weights=1,optimizer=NEWTON,max.iter=10," \
                  "random.effect.type="
        for name, sweeps in (("plain", "2"), ("distributed", "1")):
            game_training_driver.main([
                "--input-data-path", str(avro["train"]), "--root-output-dir",
                str(drivers / name), "--task-type", "LOGISTIC_REGRESSION", *shards,
                "--coordinate-configurations",
                "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
                "--coordinate-configurations", f"name=per_user,{re_spec}userId",
                "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
                "--coordinate-descent-iterations", sweeps], device=on)
        game_scoring_driver.main([
            "--input-data-path", str(avro["validation"]), "--model-input-dir",
            str(drivers / "plain" / "best"), "--output-dir", str(drivers / "scores-plain"),
            *shards], device=on)
    t0 = time.perf_counter()
    summary = serve_driver.main([
        "--requests-avro", str(avro["validation"]), "--model-input-dir",
        str(drivers / "plain" / "best"), "--output-dir", str(tmp / "served"), *shards,
        "--request-rows", str(SERVING["driver_request_rows"]), "--swap-model-dir",
        str(drivers / "distributed" / "best")], device=on)
    seconds = time.perf_counter() - t0
    assert summary["num_rows"] == avro["held_out"] and summary["replay_compiles"] == 0 \
        and summary["swap"]["score_compiles_after_swap"] == 0, summary
    # the resident scores of the same rows and model against the scoring driver's
    model, maps, cfgs, vocabs, re_cols = _load_scoring_model(
        model_input_dir=str(drivers / "plain" / "best"), index_maps_dir=None,
        feature_shards=dict(parse_feature_shard_config(s) for s in shards[1::2]),
        compact_random_effect_threshold=serve_driver.DEFAULT_COMPACT_RE_THRESHOLD, device=dev)
    ds = read_partitioned(str(avro["validation"]), cfgs, index_maps=maps,
                          random_effect_id_columns=re_cols, entity_vocabs=vocabs,
                          device="cpu").result.dataset
    scorer = ResidentScorer(model, shapes=SERVING["shapes"])
    got = scorer.score(ds)
    written = np.asarray([r["predictionScore"] for r in read_scores(drivers / "scores-plain"
                                                                     / "scores")])
    gap = float(np.abs(got.astype(np.float64) - written).max())
    scale = float(np.abs(written).max())
    assert gap <= 1e-6 * scale, (gap, scale)
    out = {"summary": summary, "seconds": seconds, "scored_gap_to_scoring_driver": gap,
           "bitwise": bool(np.array_equal(got.astype(np.float64), written))}
    _log(f"17e. the serve driver on {avro['held_out']} flagship-width Avro rows ({card}): "
         + json.dumps(out))
    return out


def _serving_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 17, serving (``photon_ml_torch/serving``, ``cli/serve_driver``):
    (a) the flagship, (b) the sparse GAME models, (c) hot swaps, (d) bf16,
    (e) the serve driver. Returns, for each kernel this path runs, its
    launches in (b)'s warm-ups and replays and its checks inside the
    captured path."""
    t0 = time.perf_counter()
    flagship = _serving_flagship(torch, np, seed, dev, card)
    torch.cuda.empty_cache()
    path, sparse = _serving_sparse(torch, np, seed, dev, card)
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="serving-", dir=_SHARED.get(
        "dir", Path(__file__).resolve().parent / "build")))
    try:
        driver = _serving_driver(torch, np, seed, dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _log(f"17. serving in {time.perf_counter() - t0:.2f} s ({card}): flagship "
         f"{flagship['replay']['scores_per_s']:.0f} scores/s batched against "
         f"{flagship['unbatched_scores_per_s']:.0f} one request a micro-batch, latency p50 "
         f"{flagship['replay']['latency_ms_p50']:.3f} ms p95 "
         f"{flagship['replay']['latency_ms_p95']:.3f} ms, pad fraction "
         f"{flagship['replay']['pad_fraction']:.4f}, captures at warm-up "
         f"{flagship['warm']['captures']} and in the replay {flagship['replay']['captures']}; "
         f"serve driver {driver['summary']['scores_per_sec']:.0f} scores/s")
    replay = flagship["replay"]
    path["sparse_gather"]["serving"] = {
        "flagship_scores_per_s": replay["scores_per_s"],
        "flagship_unbatched_scores_per_s": flagship["unbatched_scores_per_s"],
        "latency_ms_p50": replay["latency_ms_p50"], "latency_ms_p95": replay["latency_ms_p95"],
        "pad_fraction": replay["pad_fraction"], "warm_captures": flagship["warm"]["captures"],
        "replay_captures": replay["captures"],
        "sparse_scores_per_s": sparse["runs"]["ELL"]["replay"]["scores_per_s"],
        "driver_scores_per_s": driver["summary"]["scores_per_sec"]}
    return path


#: phase 18's cells: (a) the flagship of phase 7 (``GAME["flagship"]``) with
#: L-BFGS lanes of ``lane_iterations`` and a live function stop at 1e-6, the
#: scheduler probing ``probe`` iterations, freezing at ``freeze``
#: (coefficient, gradient), and in float64 with the lanes run to the stop of
#: ``held`` (iterations, function tolerance), where scheduled and unscheduled
#: fits are held to 1e-5 rel; (c) ``refresh_users`` users' labels redrawn;
#: (d) phase 4's dense problem (``grid_lambdas`` λ log-spaced over [1e-2,
#: 1e2] at ``grid_budget`` iterations) and phase 5's scaled ELL
#: (``sparse_lambdas``); (e) ``search_rounds`` × ``search_lanes`` GP rounds
#: with AUC on ``held_out`` rows, the drivers on phase 8's cut rows
#: (``DRIVERS``); (f) phase 16(a)'s streamed flagship for ``stream_sweeps``
#: sweeps.
SEARCH = dict(lane_iterations=20, fe_iterations=30, probe=2, freeze=(0.12, 1e-2),
              held=(100, 1e-10), refresh_users=100,
              grid_lambdas=8, grid_budget=20, sparse_lambdas=(0.1, 0.3, 1.0, 3.0),
              search_rounds=3, search_lanes=8, held_out=1 << 16, glm_lambdas=(0.1, 1.0, 10.0),
              driver_budget=20, stream_sweeps=2, rank_timeout_s=600, dense=(1 << 18, 512))


def _search_estimator(sweeps: int, scheduler=None, *, explicit_none: bool = False,
                      lane_iterations: int | None = None, rel_function_tolerance: float = 1e-6,
                      **kw):
    """``_game_estimator``'s flagship configuration with L-BFGS lanes of
    ``lane_iterations`` (``SEARCH["lane_iterations"]``) and a live function
    stop at ``rel_function_tolerance`` on both random effects (the fixed
    effect ``SEARCH["fe_iterations"]``, so that its solve ends on its own
    tests and the runs compare their lanes), lane-scheduled by ``scheduler``
    (a LaneSchedulerConfig; with ``explicit_none`` the field is passed as
    None)."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    lanes = dict(max_iterations=lane_iterations or SEARCH["lane_iterations"],
                 rel_function_tolerance=rel_function_tolerance)
    if scheduler is not None or explicit_none:
        lanes["scheduler"] = scheduler

    def opt(**o):
        return CoordinateOptimizationConfig(optimizer=OptimizerConfig(OptimizerType.LBFGS, **o),
                                            l2_weight=1.0)

    configs = {"fixed": FixedEffectCoordinateConfig(
        "global", opt(max_iterations=SEARCH["fe_iterations"]))}
    for cid, re_type in (("per_user", "user"), ("per_item", "item")):
        configs[cid] = RandomEffectCoordinateConfig(re_type, "per_entity", opt(**lanes),
                                                    bucket_sizes=(GAME["cap"],))
    return GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=configs,
                         num_iterations=sweeps, **kw)


class _SchedulerLog:
    """The SchedulerStats of every ``LaneScheduler.solve`` while open, in
    call order, by wrapping the method (restored on exit). Beside them, for
    each call: whether it was a final sweep, whether the active set was reset
    after it, and, where it skipped frozen lanes, whether every frozen table
    row came out bitwise as it went in."""

    def __enter__(self):
        import torch

        from photon_ml_torch.algorithm.lane_scheduler import LaneScheduler

        self.calls: list = []
        self.checks: list = []
        self._solve = solve = LaneScheduler.solve

        def recorded(sched, objective, opt, blocks, full_offsets, table, **kw):
            frozen = sched.frozen_rows
            before = None if frozen is None or not frozen.any() else (frozen.copy(),
                                                                      table.clone())
            out = solve(sched, objective, opt, blocks, full_offsets, table, **kw)
            stats = dataclasses.asdict(out[2])
            check = {"final_sweep": kw.get("final_sweep", True),
                     "active_set_reset": sched.frozen_rows is None}
            if before is not None and stats["lanes_frozen_skipped"]:
                mask = torch.as_tensor(before[0], device=table.device)
                check["frozen_rows_kept"] = bool(torch.equal(before[1][mask], out[0][mask]))
            self.calls.append(stats)
            self.checks.append(check)
            return out

        LaneScheduler.solve = recorded
        return self

    def __exit__(self, *exc):
        from photon_ml_torch.algorithm.lane_scheduler import LaneScheduler

        LaneScheduler.solve = self._solve

    def per_sweep(self, coordinates: int) -> list:
        """The calls summed over each sweep's ``coordinates`` scheduled solves."""
        out = []
        for i in range(0, len(self.calls), coordinates):
            total: dict = {}
            for c in self.calls[i:i + coordinates]:
                for k, v in c.items():
                    total[k] = total.get(k, 0) + v
            out.append(total)
        return out


def _models_equal(a, b) -> bool:
    """Every array of two GameModels bitwise equal."""
    import numpy as np

    from photon_ml_torch import convert

    x, y = convert.game_model_to_numpy(a), convert.game_model_to_numpy(b)
    return list(x) == list(y) and all(
        np.array_equal(x[c][k], y[c][k]) for c in x for k in x[c]
        if isinstance(x[c][k], np.ndarray))


def _logistic_loss(torch, model, dataset) -> float:
    """The weighted mean logistic loss of ``model``'s scores on ``dataset``."""
    m = (model.score(dataset) + dataset.offsets).double()
    y, w = dataset.labels.double(), dataset.weights.double()
    return float(torch.sum(w * (torch.nn.functional.softplus(m) - y * m)) / torch.sum(w))


def _search_flagship(torch, np, seed: int, dev, card: str) -> dict:
    """18(a): the flagship three ways through ``GameEstimator.fit`` in f32
    (timed; the scheduled runs' final-loss gaps printed), and unscheduled
    against probe/rescue in f64 with the lanes run to their stop, held to
    1e-5 rel. A 1e-6 function stop ends a lane wherever its L-BFGS history
    puts it, and the rescue restarts that history, so at the f32 runs' stop
    the two fits part by the stop's own width, not by rounding (f64 on the
    CPU: 5.3e-5 rel at 1e-6, 4.7e-6 at 1e-7, 2.5e-9 at 1e-10); run to the
    stop of ``SEARCH["held"]`` the fits agree, and a fault of the rescue or
    its scatter shows. The freezing run is held to the skip's own semantics:
    lanes frozen in sweep 2 and skipped in sweep 3, their table rows bitwise
    kept, the active set gone after the final sweep."""
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.optim.optimizer import LaneSchedulerConfig
    from dev import torch_kernel_probe

    shape = GAME["flagship"]
    sweeps = shape["sweeps"]
    if "game_flagship" in _SHARED:  # phase 7's training rows and dataset
        train, ds = _SHARED.pop("game_flagship")
    else:
        train, _ = _game_arrays(np, seed, **shape)
        ds = _game_dataset(train, "LOGISTIC_REGRESSION", dev)
    probe = LaneSchedulerConfig(probe_iterations=SEARCH["probe"])
    freeze = LaneSchedulerConfig(probe_iterations=SEARCH["probe"],
                                 freeze_coefficient_tolerance=SEARCH["freeze"][0],
                                 freeze_gradient_tolerance=SEARCH["freeze"][1])
    runs, launches = {}, {"packed_glm": 0, "packed_glm_reduce": 0}
    for label, sched in (("unscheduled", None), ("probe/rescue", probe),
                         ("probe/rescue + freezing", freeze)):
        with _SchedulerLog() as log:
            fit = _game_fit(torch, f"18a {label}", _search_estimator(sweeps, sched), ds, sweeps)
        launches["packed_glm"] += fit["launches"]["packed_launches"] \
            - fit["launches"]["mma_launches"]
        launches["packed_glm_reduce"] += fit["launches"]["reduce_launches"]
        fit["scheduler_per_sweep"] = log.per_sweep(2)
        fit["scheduler_checks"] = log.checks
        if sched is not freeze:  # an update alone is a final sweep: freezing skips nothing
            fit["profiled_update"] = _lane_loop_share(torch, _search_estimator(1, sched), ds)
        runs[label] = fit
        _log(f"18a {label} ({card}): {fit['seconds_per_sweep']:.4f} s a sweep, final loss "
             f"{fit['loss_per_sweep'][-1]:.9g}, per sweep {json.dumps(fit['scheduler_per_sweep'])}; "
             f"one per-user update {json.dumps(fit.get('profiled_update'))}")
    base = runs["unscheduled"]
    for label in ("probe/rescue", "probe/rescue + freezing"):
        runs[label]["final_loss_gap"] = _rel_gap(runs[label]["loss_per_sweep"][-1],
                                                 base["loss_per_sweep"][-1])
    per_sweep = runs["probe/rescue"]["scheduler_per_sweep"]
    assert sum(s["lanes_rescued"] for s in per_sweep) > 0 and all(
        s["lanes_probed"] > 0 for s in per_sweep), per_sweep
    frozen = runs["probe/rescue + freezing"]
    middle = frozen["scheduler_per_sweep"][1:3]
    assert sum(s["lanes_newly_frozen"] for s in middle) > 0 \
        and sum(s["lanes_frozen_skipped"] for s in middle) > 0, \
        f"18a: no lane froze and was skipped in sweeps 2-3: {frozen['scheduler_per_sweep']}"
    checks = frozen["scheduler_checks"]
    assert all(c.get("frozen_rows_kept", True) for c in checks), \
        f"18a: a skipped lane's table row changed: {checks}"
    assert all(c["active_set_reset"] for c in checks if c["final_sweep"]) \
        and any(c["final_sweep"] for c in checks), f"18a: the active set outlived the fit: {checks}"
    explicit = _search_estimator(sweeps, None, explicit_none=True).fit(ds).model
    assert _models_equal(explicit, base["result"].model), \
        "18a: scheduler=None is not bitwise the fit built without the field"

    # f64, the closed form on the fixed effect (the packed kernel takes f32
    # and bf16), the lanes run to their stop: scheduled within 1e-5 rel
    ds64 = _game_dataset(train, "LOGISTIC_REGRESSION", dev, dtype=np.float64)
    iterations, rel = SEARCH["held"]
    held = {}
    for label, sched in (("unscheduled", None), ("probe/rescue", probe)):
        est = _search_estimator(sweeps, sched, lane_iterations=iterations,
                                rel_function_tolerance=rel, use_kernel=False)
        held[label] = _game_fit(torch, f"18a f64 {label}", est, ds64, sweeps)
    del ds64
    held_gap = _rel_gap(held["probe/rescue"]["loss_per_sweep"][-1],
                        held["unscheduled"]["loss_per_sweep"][-1])
    assert held_gap <= 1e-5, f"18a f64: probe/rescue's final loss {held_gap} rel from " \
                             "the unscheduled fit's (limit 1e-5)"
    _log("18a final losses against unscheduled: f32 at the 1e-6 stop (printed) " + ", ".join(
        f"{k} {runs[k]['final_loss_gap']:.3g}" for k in ("probe/rescue",
                                                          "probe/rescue + freezing"))
         + f"; f64 run to the stop ({iterations} iterations, {rel:g}) probe/rescue "
         f"{held_gap:.3g} (limit 1e-5), {held['probe/rescue']['seconds_per_sweep']:.4f} against "
         f"{held['unscheduled']['seconds_per_sweep']:.4f} s a sweep; freezing: frozen rows kept "
         "bitwise where skipped, the active set reset; scheduler=None bitwise the plain fit")

    # P6 and its reduce on the scheduled fit's fixed effect
    model = runs["probe/rescue"]["result"].model
    x = ds.feature_shards["global"]
    w = model.get("fixed").glm.coefficients.means.float().contiguous()
    residual = model.score(ds) - x @ w
    aux = packed_glm.pack_aux(ds.labels, (ds.offsets + residual).contiguous(), ds.weights)
    loss = LogisticLoss()
    n, d = x.shape
    r = torch.rand(n, device=dev)
    checks = {"packed_glm": _path_check(
        torch, "18a packed_glm on the scheduled fit's fixed effect",
        lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
        lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
        lambda: (torch.matmul(x, w), torch.matmul(r, x)), torch_kernel_probe.limits("float32"),
        n * d * 4 + 12 * n + 8 * d + 8, x.shape)}
    p6 = (loss, x, aux, None, None, None, w, None, True, "fma", "fma")
    checks["packed_glm_reduce"] = _reduce_entry(
        torch, "18a packed_glm_reduce", lambda: packed_glm.launch_partials(*p6),
        packed_glm.reduce_partials, packed_glm.reduce_partials_reference)
    del aux, residual, p6
    summary = {k: {kk: v[kk] for kk in ("seconds_per_sweep", "loss_per_sweep",
                                         "scheduler_per_sweep", "profiled_update",
                                         "final_loss_gap") if kk in v}
               for k, v in runs.items()}
    summary["f64"] = {"iterations": iterations, "rel_function_tolerance": rel,
                      "final_loss_gap": held_gap,
                      **{k: {kk: v[kk] for kk in ("seconds_per_sweep", "loss_per_sweep")}
                         for k, v in held.items()}}
    return {"runs": summary, "launches": launches, "checks": checks, "train": train,
            "dataset": ds, "resident": base["result"].model}


def _search_refresh(torch, np, seed: int, dev, card: str, flagship: dict, tmp: Path) -> dict:
    """18(c): an incremental refresh of 18(a)'s unscheduled model."""
    from photon_ml_torch.algorithm import coordinates
    from photon_ml_torch.algorithm.refresh import (
        RefreshFingerprintError,
        RefreshPolicy,
        expected_fingerprint,
    )
    from photon_ml_torch.io.checkpoint import TrainingCheckpointer
    from photon_ml_torch.ops import packed_glm

    train, resident, old_ds = flagship["train"], flagship["resident"], flagship["dataset"]
    rng = np.random.default_rng(seed + 18)
    vocab = np.asarray(old_ds.entity_vocabs["user"])
    changed = rng.choice(vocab, size=SEARCH["refresh_users"], replace=False)
    rows = np.isin(train["keys"]["user"], changed)
    labels = train["labels"]["LOGISTIC_REGRESSION"].copy()
    labels[rows] = (rng.uniform(size=int(rows.sum())) < 0.5).astype(labels.dtype)
    new = dict(train, labels=dict(train["labels"], LOGISTIC_REGRESSION=labels))
    ds = _game_dataset(new, "LOGISTIC_REGRESSION", dev, vocabs=old_ds.entity_vocabs)
    est = _search_estimator(GAME["flagship"]["sweeps"])
    policy = RefreshPolicy(changed_entities={"user": changed.tolist()})

    selections: dict = {}
    set_selection = coordinates.RandomEffectCoordinate.set_refresh_selection

    def recorded(coord, selected):
        if selected is not None:
            selections[coord.coordinate_id] = np.asarray(selected).copy()
        return set_selection(coord, selected)

    coordinates.RandomEffectCoordinate.set_refresh_selection = recorded
    try:
        est.refresh(ds, resident, policy)  # warm-up outside the times
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = est.refresh(ds, resident, policy)
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t0
    finally:
        coordinates.RandomEffectCoordinate.set_refresh_selection = set_selection
    for cid, mask in selections.items():
        old = resident.get(cid).coefficients
        got = result.model.get(cid).coefficients
        keep = torch.as_tensor(~mask, device=old.device)
        assert torch.equal(old[keep], got[keep]), f"18c {cid}: an unselected row moved"
    declared = np.isin(vocab, changed)
    assert selections["per_user"][declared].all(), "18c: a declared user was not selected"
    extra = {"per_user": int(selections["per_user"].sum()) - int(declared.sum()),
             "per_item": int(selections["per_item"].sum())}
    before, after = _logistic_loss(torch, resident, ds), _logistic_loss(torch, result.model, ds)
    assert after <= before, f"18c: the refresh raised the loss on the new data {before} -> {after}"

    # stopped after its first coordinate and resumed
    seq = list(est.coordinate_configs)
    fingerprint = expected_fingerprint(ds, est.coordinate_configs, seq, {"per_user": 1.0})
    ck = TrainingCheckpointer(tmp / "refresh-ck")
    update = coordinates.RandomEffectCoordinate.update_model

    def stop(coord, *args, **kw):
        if coord.coordinate_id == "per_item":
            raise KeyboardInterrupt("stopped after the first random effect")
        return update(coord, *args, **kw)

    coordinates.RandomEffectCoordinate.update_model = stop
    try:
        est.refresh(ds, resident, policy, checkpointer=ck, fingerprint=fingerprint)
        raise AssertionError("18c: the stopped refresh ran to its end")
    except KeyboardInterrupt:
        pass
    finally:
        coordinates.RandomEffectCoordinate.update_model = update
    resumed = est.refresh(ds, resident, policy, checkpointer=ck, fingerprint=fingerprint).model
    assert _models_equal(resumed, result.model), "18c: the resumed refresh is not bitwise"
    other = expected_fingerprint(ds, est.coordinate_configs, seq, {"per_user": 3.0})
    try:
        est.refresh(ds, resident, policy, checkpointer=ck, fingerprint=other)
        raise AssertionError("18c: a checkpoint under another λ was accepted")
    except RefreshFingerprintError as err:
        assert "per_user/lambda" in str(err), err

    # the fixed effect refreshed too: P6 on the refresh's path
    before_p6 = packed_glm.packed_launches
    with_fe = est.refresh(ds, resident, RefreshPolicy(changed_entities=policy.changed_entities,
                                                      refresh_fixed_effects=True))
    p6 = packed_glm.packed_launches - before_p6
    assert p6 > 0 and with_fe.coordinate_stats["fixed"]["refreshed"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(ds)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    out = {"refresh_seconds": refresh_s, "fit_seconds": fit_s, "ratio": refresh_s / fit_s,
           "lanes_total": result.lanes_total, "lanes_solved": result.lanes_solved,
           "lanes_changed": result.lanes_changed, "lanes_gradient": result.lanes_gradient,
           "screen_added": extra, "loss_before": before, "loss_after": after,
           "rescue_blocks": {c: s.get("rescue_blocks", 0)
                             for c, s in result.coordinate_stats.items()},
           "p6_launches": p6}
    _log(f"18c refresh ({card}): {json.dumps(out)}")
    return out


def _search_program(scheduled: bool, mesh=None):
    """Phase 13's flagship program on its Avro columns (``_fused_program``,
    FE + per-user: L-BFGS on the fixed effect, AUTO lanes, that is Newton,
    on the per-user effect), the per-user lanes probe/rescue scheduled when
    ``scheduled``."""
    from photon_ml_torch.optim.optimizer import LaneSchedulerConfig, OptimizerConfig, OptimizerType
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.types import TaskType

    lanes = OptimizerConfig(OptimizerType.AUTO, max_iterations=10,
                            scheduler=LaneSchedulerConfig(probe_iterations=SEARCH["probe"])
                            if scheduled else None)
    return dist.GameTrainProgram(
        TaskType.LOGISTIC_REGRESSION,
        dist.FixedEffectStepSpec("global", OptimizerConfig(OptimizerType.LBFGS,
                                                           max_iterations=10), l2_weight=1.0),
        (dist.RandomEffectStepSpec("userId", "per_entity", lanes, l2_weight=1.0),), mesh=mesh)


def _search_rank_main(rank: int, world: int, tmp: str, device_type: str, device_index: int,
                      job: dict) -> None:
    """One rank of 18(b)'s two: a partitioned read of the flagship Avro and
    ``train_partitioned`` with this rank's lane schedulers; writes its report
    and state into ``tmp``. A module function, so a spawned process runs it."""
    import datetime

    import numpy as np
    import torch

    from photon_ml_torch import convert
    from photon_ml_torch.algorithm.lane_scheduler import make_schedulers
    from photon_ml_torch.data.game_data import build_random_effect_dataset_partitioned
    from photon_ml_torch.io.partitioned_reader import read_partitioned
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.parallel import mesh as mesh_ops
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh

    try:
        dev = torch.device(device_type, device_index) if device_type == "cuda" \
            else torch.device(device_type)
        multihost.initialize(f"file://{tmp}/rendezvous", world, rank, local_rank=device_index,
                             device=dev, backend="gloo",
                             timeout=datetime.timedelta(seconds=SEARCH["rank_timeout_s"]))
        mesh = make_mesh()
        ex = multihost.default_exchange()
        part = read_partitioned(job["train"], _partitioned_cfg("flagship"), exchange=ex,
                                random_effect_id_columns=("userId",), tag="search", device=dev)
        res = {"userId": build_random_effect_dataset_partitioned(
            part.result.dataset, "userId", "per_entity", partition=part.partition, exchange=ex,
            bucket_sizes=(GAME["cap"],),
            entity_rank_presence=part.entity_rank_presence.get("userId"), tag="search/user")}
        program = _search_program(True, mesh)
        schedulers = make_schedulers(program.re_specs)
        fused_glm.launches = fused_glm.reduce_launches = 0
        mesh_ops.counts.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = dist.train_partitioned(program, {rank: (part.result.dataset, res)}, mesh, world,
                                        num_iterations=job["sweeps"], exchange=ex,
                                        schedulers=schedulers)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        flat = _flat_state(convert.train_state_to_numpy(result.state))
        np.savez(Path(tmp) / f"search-state-{rank}.npz", **flat)
        out = {"losses": result.losses, "seconds": seconds,
               "collectives": mesh_ops.counts.snapshot(),
               "launches": {"fused_glm": fused_glm.launches,
                            "fused_glm_reduce": fused_glm.reduce_launches},
               "scheduler": {k: dataclasses.asdict(v.total_stats)
                             for k, v in schedulers.items()},
               "rows": part.partition.local_n}
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out, default=float))
    finally:
        multihost.shutdown()


def _search_fused(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """18(b): the scheduled fused program on two ranks and, while they run,
    on one device."""
    from photon_ml_torch import convert
    from photon_ml_torch.data.game_data import build_random_effect_dataset
    from photon_ml_torch.io.data_reader import read_merged
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.parallel import distributed as dist

    avro = _flagship_avro(np, seed, tmp)
    sweeps = GAME["flagship"]["sweeps"]
    two_cards = torch.cuda.device_count() >= 2
    ranks_dir = tmp / "search-ranks"
    ranks_dir.mkdir(parents=True, exist_ok=True)
    job = {"train": str(avro["train"]), "sweeps": sweeps}
    ctx = _processes()
    procs = [ctx.Process(target=_search_rank_main,
                         args=(r, 2, str(ranks_dir), dev.type, r if two_cards else 0, job))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        full = read_merged(avro["train"], _partitioned_cfg("flagship"),
                           random_effect_id_columns=("userId",), device=dev).dataset
        res = {"userId": build_random_effect_dataset(full, "userId", "per_entity",
                                                     bucket_sizes=(GAME["cap"],))}
        program = _search_program(True)
        fused_glm.launches = fused_glm.reduce_launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one = dist.train_distributed(program, full, res, num_iterations=sweeps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches = {"fused_glm": fused_glm.launches,
                    "fused_glm_reduce": fused_glm.reduce_launches}
        assert all(v > 0 for v in launches.values()), launches
        assert all(b <= a * (1 + 1e-5) for a, b in zip(one.losses, one.losses[1:])), one.losses
        data, _ = program.prepare_inputs(full, res)
        checks = _mesh_b1_checks(torch, "18b the scheduled step's fixed effect", program, data,
                                 one.state)
        flat_one = _flat_state(convert.train_state_to_numpy(one.state))
        del data, full, res
    finally:
        for p in procs:
            p.join(SEARCH["rank_timeout_s"])
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(30)
    assert not alive and all(p.exitcode == 0 for p in procs), \
        ("18b ranks", [p.exitcode for p in procs])
    ranks_s = time.perf_counter() - t0
    reports = [json.loads((ranks_dir / f"rank{r}.json").read_text()) for r in range(2)]
    states = [dict(np.load(ranks_dir / f"search-state-{r}.npz")) for r in range(2)]
    assert reports[0]["losses"] == reports[1]["losses"], "18b: the ranks' losses differ"
    gap, scale, _ = _state_gap(np, states[0], flat_one)
    assert gap <= 1e-3 * scale, f"18b: two ranks {gap} from one device (max |w| {scale})"
    for k in ("fused_glm", "fused_glm_reduce"):
        launches[k] += sum(r["launches"][k] for r in reports)
    out = {"one_device_seconds_per_sweep": seconds / sweeps, "one_device_losses": one.losses,
           "two_ranks_losses": reports[0]["losses"], "state_gap": gap, "state_scale": scale,
           "collectives_per_sweep": {op: {k: v / sweeps for k, v in c.items()}
                                     for op, c in reports[0]["collectives"].items()},
           "two_ranks_seconds_per_sweep": reports[0]["seconds"] / sweeps,
           "ranks_wall_seconds": ranks_s,
           "scheduler": [r["scheduler"] for r in reports]}
    _log(f"18b fused program ({card}): {json.dumps(out)}")
    return {"summary": out, "launches": launches, "checks": checks}


def _search_grid(torch, np, seed: int, dev, card: str) -> dict:
    """18(d) dense and 18(e)'s tournament and model search on phase 4's
    problem."""
    from photon_ml_torch.algorithm.lane_search import LaneConfigs
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.estimators import train_glm, train_glm_grid, train_glm_tournament
    from photon_ml_torch.hyperparameter.search_driver import parse_search_space, run_model_search
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.ops.normalization import (
        NormalizationContext,
        NormalizationType,
        build_normalization,
    )
    from photon_ml_torch.optim.common import ConvergenceReason
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    (n, d), held = SEARCH["dense"], SEARCH["held_out"]
    x_np, y_np = _dataset(np, seed, n + held, d)
    batch = LabeledPointBatch.create(x_np[:n], y_np[:n], device=dev)
    val = LabeledPointBatch.create(x_np[n:], y_np[n:], device=dev)
    del x_np
    xd = batch.features.double()
    norm = build_normalization(NormalizationType.STANDARDIZATION, mean=xd.mean(0),
                               variance=xd.var(0), max_magnitude=xd.abs().amax(0),
                               intercept_index=d - 1)
    norm = NormalizationContext(norm.factors.float(), norm.shifts.float())
    del xd
    task = TaskType.LOGISTIC_REGRESSION
    lams = np.logspace(-2, 2, SEARCH["grid_lambdas"])
    common = dict(normalization=norm, intercept_index=d - 1)
    budget = OptimizerConfig(OptimizerType.LBFGS, max_iterations=SEARCH["grid_budget"])
    full = OptimizerConfig(OptimizerType.LBFGS, max_iterations=100)
    max_iter = int(ConvergenceReason.MAX_ITERATIONS)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    timed(lambda: train_glm_grid(batch, task, optimizer=budget, regularization_weights=lams,
                                 **common))  # warm-up
    uniform = LaneConfigs(l2=lams, l1=np.zeros(len(lams)),
                          tolerance=np.full(len(lams), budget.tolerance))
    out: dict = {"lambdas": lams.tolist(), "runs": {}}
    b1_before = fused_glm.launches
    for label, opt in (("budget 20", budget), ("to the stopping tests", full)):
        grid, grid_s = timed(lambda: train_glm_grid(batch, task, optimizer=opt,
                                                    regularization_weights=lams, **common))
        tour = train_glm_tournament(batch, task, uniform, optimizer=opt, **common)
        for lam, model in zip(lams, tour.models):
            assert torch.equal(model.coefficients.means, grid[float(lam)].coefficients.means), \
                f"18e: the uniform tournament is not bitwise the grid at λ={lam}"
        cold, cold_s = {}, 0.0
        for lam in lams:
            solved = {}
            m, s = timed(lambda: train_glm(batch, task, optimizer=opt,
                                           regularization_weights=(float(lam),),
                                           on_solve=lambda l_, r_: solved.update(r=r_),
                                           **common))
            cold[float(lam)] = (m[float(lam)], solved["r"])
            cold_s += s
        rows = []
        for i, lam in enumerate(lams):
            model, result = cold[float(lam)]
            reasons = (int(tour.results.reason[i]), int(result.reason))
            wg = grid[float(lam)].coefficients.means.double()
            wc = model.coefficients.means.double()
            coef_gap = float((wg - wc).abs().max() / wc.abs().max())
            value_gap = _rel_gap(float(tour.results.value[i]), float(result.value))
            rows.append({"lambda": float(lam), "reasons": reasons,
                         "iterations": (int(tour.results.iterations[i]), int(result.iterations)),
                         "coef_gap": coef_gap, "value_gap": value_gap})
            if reasons == (max_iter, max_iter):
                assert coef_gap <= 1e-3, f"18d {label} λ={lam}: coefficients {coef_gap} apart"
            else:
                assert value_gap <= 1e-6, f"18d {label} λ={lam}: final values {value_gap} apart"
        run = {"grid_seconds": grid_s, "cold_seconds": cold_s, "lanes": rows}
        if opt is budget:
            _, run["warm_sequential_seconds"] = timed(lambda: train_glm(
                batch, task, optimizer=opt, regularization_weights=lams, **common))
        out["runs"][label] = run
        _log(f"18d dense grid, {label} ({card}): {json.dumps(run)}")
    b1 = fused_glm.launches - b1_before
    enet, enet_s = timed(lambda: train_glm_grid(batch, task, optimizer=budget,
                                                regularization_weights=lams,
                                                elastic_net_alpha=0.5, **common))
    var, var_s = timed(lambda: train_glm_grid(batch, task, optimizer=budget,
                                              regularization_weights=lams, compute_variance=True,
                                              variance_mode="diagonal", **common))
    for lam in lams:
        assert bool(torch.isfinite(enet[float(lam)].coefficients.means).all())
        v = var[float(lam)].coefficients.variances
        assert bool(torch.isfinite(v).all()) and bool((v > 0).all()), "18d: variances"
    zeros = [int((enet[float(lam)].coefficients.means == 0).sum()) for lam in lams]
    out.update(elastic_net_seconds=enet_s, elastic_net_zeros=zeros, variances_seconds=var_s)
    _log(f"18d elastic-net grid (OWL-QN lanes) {enet_s:.3f} s, zeros per lane {zeros}; "
         f"diagonal variances grid {var_s:.3f} s")

    # 18e: the GP model search, its AUC on the held-out rows reduced on the device
    space = parse_search_space("lambda=1e-3:1e3:log,tolerance=1e-9:1e-5:log")
    search, search_s = timed(lambda: run_model_search(
        batch, val, task, space, rounds=SEARCH["search_rounds"],
        lane_budget=SEARCH["search_lanes"],
        optimizer=OptimizerConfig(OptimizerType.LBFGS, max_iterations=SEARCH["grid_budget"],
                                  rel_function_tolerance=1e-6),
        seed=0, searcher="gp", evaluator="AUC", **common))
    best = [r["best_metric"] for r in search.trajectory]
    assert all(b2 >= b1_ for b1_, b2 in zip(best, best[1:])) and best[-1] > 0.6, best
    out["search"] = {"seconds": search_s, "round_ms": [r["round_ms"] for r in search.trajectory],
                     "best_auc": best, "sources": [r["source"] for r in search.trajectory],
                     "best_config": search.best_config}
    _log(f"18e model search ({card}): {json.dumps(out['search'])}")
    return {"summary": out, "launches": {"fused_glm": b1, "fused_glm_reduce": b1}}


def _search_ell(torch, np, seed: int, dev):
    """Phase 5's scaled ELL batch (kept by phase 5, else built here)."""
    if "ell" in _SHARED:
        return _SHARED["ell"]
    from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch, summarize_sparse
    from photon_ml_torch.ops.normalization import NormalizationType, build_normalization

    cfg = SPARSE["ell"]
    (rows, cols, vals, y), _ = _planted_ell_data(np, seed, cfg["n"], cfg["d"], cfg["per_row"], 0)
    ell = SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=cfg["d"], device=dev)
    stats = summarize_sparse(rows, cols, vals, n=cfg["n"], dim=cfg["d"])
    stat = {k: torch.as_tensor(stats[k], dtype=torch.float32, device=dev)
            for k in ("mean", "variance", "max_magnitude")}
    return ell, build_normalization(NormalizationType.SCALE_WITH_STANDARD_DEVIATION, **stat)


def _search_sparse(torch, np, seed: int, dev, card: str) -> dict:
    """18(d) sparse: the λ lanes on phase 5's ELL, scaled (G1's launches
    counted, G1 held on the lanes' inputs) and unscaled. Each lane is held to
    ``train_glm`` at its λ under the same budget: the unscaled lanes in f32
    through G1, the scaled ones in f64 through the plain gathers (G1 takes
    f32 and bf16). Scaled by their deviations the columns seen once or twice
    fit the rows alone (phase 5): two f32 paths part there after 20
    iterations, and the f32 lanes' gaps to the f64 ones are printed."""
    from photon_ml_torch.algorithm import lane_search
    from photon_ml_torch.estimators import train_glm, train_glm_grid
    from photon_ml_torch.ops.normalization import NormalizationContext
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    ell, scale = _search_ell(torch, np, seed, dev)
    lams = SEARCH["sparse_lambdas"]
    budget = OptimizerConfig(OptimizerType.LBFGS, max_iterations=SEARCH["grid_budget"])
    task = TaskType.LOGISTIC_REGRESSION
    out: dict = {"history_bytes": 2 * budget.history * len(lams) * ell.dim * 4}
    launches = {"sparse_gather": 0, "sparse_gather_chunks": 0}
    grids = {}
    for label, norm in (("scaled", scale), ("unscaled", None)):
        _reset_gather_counts()
        evals = lane_search.lane_evaluations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = train_glm_grid(ell, task, optimizer=budget, regularization_weights=lams,
                              normalization=norm)
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        counts = _gather_counts()
        evals = lane_search.lane_evaluations - evals
        assert counts["rows"] == counts["segments"] == len(lams) * evals > 0, (counts, evals)
        cold_s, gaps = 0.0, {}
        for lam in lams:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cold = train_glm(ell, task, optimizer=budget, regularization_weights=(lam,),
                             normalization=norm)[lam].coefficients.means.double()
            torch.cuda.synchronize()
            cold_s += time.perf_counter() - t0
            wg = grid[lam].coefficients.means.double()
            gaps[lam] = float((wg - cold).abs().max() / cold.abs().max())
        after = _gather_counts()
        launches["sparse_gather"] += after["rows"] + after["segments"]
        launches["sparse_gather_chunks"] += after["chunks"]
        out[label] = {"grid_seconds": grid_s, "cold_seconds": cold_s, "evaluations": evals,
                      "row_launches": counts["rows"], "segment_launches": counts["segments"],
                      "coef_gaps": gaps}
        grids[label] = grid
        _log(f"18d sparse grid, {label} ELL [{ell.num_samples}, d={ell.dim}] ({card}): "
             f"{json.dumps(out[label])}")
    for lam, gap in out["unscaled"]["coef_gaps"].items():
        assert gap <= 1e-3, f"18d sparse λ={lam}: the lane is {gap} from train_glm"
    # the scaled grid in f64 (the same values, exactly widened)
    ell64 = ell.replace(**{f.name: getattr(ell, f.name).double()
                           for f in dataclasses.fields(ell)
                           if isinstance(getattr(ell, f.name), torch.Tensor)
                           and getattr(ell, f.name).is_floating_point()})
    scale64 = NormalizationContext(*(None if t is None else t.double()
                                     for t in (scale.factors, scale.shifts)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid64 = train_glm_grid(ell64, task, optimizer=budget, regularization_weights=lams,
                            normalization=scale64, use_kernel=False)
    torch.cuda.synchronize()
    f64 = {"grid_seconds": time.perf_counter() - t0, "coef_gaps": {}, "f32_lane_gaps": {}}
    for lam in lams:
        cold = train_glm(ell64, task, optimizer=budget, regularization_weights=(lam,),
                         normalization=scale64, use_kernel=False)[lam].coefficients.means
        wg = grid64[lam].coefficients.means
        f64["coef_gaps"][lam] = float((wg - cold).abs().max() / cold.abs().max())
        f64["f32_lane_gaps"][lam] = float(
            (grids["scaled"][lam].coefficients.means.double() - wg).abs().max()
            / wg.abs().max())
    del ell64, grid64
    out["scaled_f64"] = f64
    _log(f"18d sparse grid, scaled ELL in f64, plain gathers ({card}): {json.dumps(f64)}")
    for lam, gap in f64["coef_gaps"].items():
        assert gap <= 1e-3, f"18d sparse scaled λ={lam}: the f64 lane is {gap} from train_glm"
    checks = _fe_gather_checks(torch, "18d sparse grid lane", ell,
                               grids["scaled"][lams[0]].coefficients.means)
    _log(f"18d sparse lanes' L-BFGS history: {out['history_bytes']} bytes (2·m·L·d·4)")
    return {"summary": out, "launches": launches, "checks": checks}


def _search_drivers(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """18(e) drivers: the GLM driver's grid lanes and model search, the GAME
    driver's tuning and refresh, on phase 8's cut rows."""
    from photon_ml_torch.cli import game_training_driver, glm_driver
    from photon_ml_torch.io import photon_schemas
    from photon_ml_torch.ops import fused_glm, packed_glm

    cfg = DRIVERS
    src = _SHARED.get("drivers_avro", tmp)  # phase 8's GLM and GAME Avro
    if "drivers_avro" not in _SHARED:
        ng, ngv, dg = cfg["glm_rows"], cfg["glm_validation_rows"], cfg["glm_d"]
        x, y = _dataset(np, seed + 4, ng + ngv, dg)
        xl, yl = x[:, :-1].tolist(), y.tolist()

        def glm_record(offset):
            return lambda i: {"uid": str(offset + i), "label": yl[offset + i],
                              "features": _ntv("f", xl[offset + i]), "weight": 1.0,
                              "offset": 0.0, "foldId": None, "metadataMap": None}

        te = photon_schemas.TRAINING_EXAMPLE_AVRO
        _write_avro(tmp / "glm/train/part-00000.avro", te, ng, glm_record(0))
        _write_avro(tmp / "glm/validation/part-00000.avro", te, ngv, glm_record(ng))
        n, nv = cfg["game_rows"], cfg["validation_rows"]
        train, held = _game_arrays(np, seed + 3, n=n, d_fe=cfg["d_fe"], d_re=cfg["d_re"],
                                   users=cfg["users"], items=cfg["items"], held_out=nv)
        jobs = _game_parts(train, tmp / "game/train", 0, 2) \
            + _game_parts(held, tmp / "game/validation", n, 1)
        with _processes().Pool(len(jobs)) as pool:
            pool.map(_write_game_part, jobs)
        del x, y, xl, yl, train, held
    out = tmp / "out"
    fused_glm.launches = fused_glm.reduce_launches = 0
    for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
        setattr(packed_glm, name, 0)
    glm_args = ["--input-data-path", str(src / "glm/train"),
                "--validation-data-path", str(src / "glm/validation"),
                "--task-type", "LOGISTIC_REGRESSION", "--max-iterations",
                str(SEARCH["driver_budget"])]
    lams = ",".join(str(l) for l in SEARCH["glm_lambdas"])
    t0 = time.perf_counter()
    grid = glm_driver.main(glm_args + ["--output-dir", str(out / "glm-grid"),
                                       "--regularization-weights", lams, "--grid-parallel"],
                           device=dev)
    grid_s = time.perf_counter() - t0
    gaps = {}
    for lam in SEARCH["glm_lambdas"]:
        cold = glm_driver.main(glm_args + ["--output-dir", str(out / f"glm-cold-{lam}"),
                                           "--regularization-weights", str(lam)], device=dev)
        wc = cold.models[lam].coefficients.means.double()
        wg = grid.models[lam].coefficients.means.double()
        gaps[lam] = float((wg - wc).abs().max() / wc.abs().max())
    t0 = time.perf_counter()
    search = glm_driver.main(glm_args + [
        "--output-dir", str(out / "glm-search"), "--search-rounds", "2",
        "--search-lane-budget", str(SEARCH["search_lanes"]),
        "--search-space", "lambda=1e-2:1e2:log,tolerance=1e-9:1e-5:log"], device=dev)
    search_s = time.perf_counter() - t0
    summary = json.loads(Path(search.summary_path).read_text())
    assert summary["search"]["configs"] == 2 * SEARCH["search_lanes"]
    assert grid.stage.name == search.stage.name == "VALIDATED"

    shards = ["--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
              "--feature-shard-configurations",
              "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
    re_spec = "feature.shard=per_entity,reg.weights=1,max.iter=20,random.effect.type="
    game_args = ["--input-data-path", str(src / "game/train"), "--task-type",
                 "LOGISTIC_REGRESSION", *shards,
                 "--coordinate-configurations", "name=fixed,feature.shard=global,reg.weights=1,"
                                                "max.iter=10",
                 "--coordinate-configurations", f"name=per_user,{re_spec}userId,scheduler=true",
                 "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
                 "--coordinate-descent-iterations", "2"]
    t0 = time.perf_counter()
    tuned = game_training_driver.main(game_args + [
        "--validation-data-path", str(src / "game/validation"), "--evaluators", "AUC",
        "--root-output-dir", str(out / "game-tuned"), "--hyperparameter-tuning", "BAYESIAN",
        "--hyperparameter-tuning-iter", "3", "--hyperparameter-tuning-range", "0.1,10"],
        device=dev)
    tune_s = time.perf_counter() - t0
    tuned_file = json.loads((out / "game-tuned/tuned-hyperparameters.json").read_text())
    keys = ["best_reg_weights", "best_value", "observations", "prior_observations"]
    assert sorted(tuned_file) == keys, sorted(tuned_file)
    assert "tuned_reg_weights" in tuned
    t0 = time.perf_counter()
    refreshed = game_training_driver.main(game_args + [
        "--root-output-dir", str(out / "game-refresh"), "--incremental-refresh",
        "--model-input-dir", str(out / "game-tuned/models/0"),
        "--index-maps-dir", str(out / "game-tuned/index-maps"),
        "--refresh-changed-entities", "userId=u1|u2|u3"], device=dev)
    refresh_s = time.perf_counter() - t0
    evidence = refreshed["incremental_refresh"]
    assert evidence["lanes_changed"] == 3 and evidence["lanes_solved"] >= 3, evidence
    launches = {"fused_glm": fused_glm.launches, "fused_glm_reduce": fused_glm.reduce_launches,
                "packed_glm": packed_glm.packed_launches - packed_glm.mma_launches,
                "packed_glm_reduce": packed_glm.reduce_launches}
    out = {"glm_grid_seconds": grid_s, "glm_grid_gaps_to_cold_runs": gaps,
           "glm_search_seconds": search_s, "glm_search": summary["search"],
           "game_tuning_seconds": tune_s, "tuned_reg_weights": tuned["tuned_reg_weights"],
           "game_refresh_seconds": refresh_s, "refresh": evidence, "launches": launches}
    _log(f"18e drivers ({card}): {json.dumps(out, default=float)}")
    for lam, gap in gaps.items():
        assert gap <= 1e-3, f"18e: --grid-parallel λ={lam} {gap} from the cold driver run"
    return {"summary": out, "launches": launches}


def _search_stream(torch, np, seed: int, dev, card: str) -> dict:
    """18(f): phase 16(a)'s streamed layout over the flagship's 2^17 rows,
    per-user scheduled against unscheduled, the final losses within 1e-5 rel."""
    from photon_ml_torch.algorithm.streaming_game import StreamingGameProgram
    from photon_ml_torch.io.stream_reader import GameArrayChunkSource
    from photon_ml_torch.optim.optimizer import (
        LaneSchedulerConfig,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_torch.parallel import distributed as dist
    from photon_ml_torch.types import TaskType

    cfg = STREAM_GAME
    # the flagship's rows uncut: at phase 16's half depth the scheduled f32
    # run's final loss parts from the unscheduled one's by more than 1e-5
    # (1.3e-5 on the CPU; 2.3e-6 there at these rows)
    train, _, user_idx = _sg_flagship(np, seed, GAME["flagship"]["n"])
    sweeps = SEARCH["stream_sweeps"]
    runs = {}
    source = GameArrayChunkSource(
        features={"global": train["x_fe"], "per_entity": train["x_re"]},
        labels=train["labels"]["LOGISTIC_REGRESSION"], entity_idx={"user": user_idx},
        chunk_records=cfg["chunk"], cluster_by="user")
    for label, sched in (("unscheduled", None),
                         ("probe/rescue", LaneSchedulerConfig(probe_iterations=SEARCH["probe"]))):
        lanes = OptimizerConfig(OptimizerType.LBFGS, max_iterations=SEARCH["lane_iterations"],
                                rel_function_tolerance=1e-6, scheduler=sched)
        fe = dist.FixedEffectStepSpec("global", OptimizerConfig(
            OptimizerType.LBFGS, max_iterations=cfg["fe_iterations"], tolerance=0.0),
            l2_weight=1.0)
        program = StreamingGameProgram(
            TaskType.LOGISTIC_REGRESSION, source, fe,
            (dist.RandomEffectStepSpec("user", "per_entity", lanes, l2_weight=1.0),),
            bucket_sizes=(GAME["cap"],), device=dev)
        run = _sg_run(torch, program, f"18f {label}", sweeps)
        losses = run["result"].losses
        assert len(losses) == sweeps and all(math.isfinite(v) for v in losses), losses
        stats = [dataclasses.asdict(s.total_stats) for s in program._lane_schedulers.values()]
        runs[label] = {"seconds": run["seconds"], "losses": losses, "chunks": source.num_chunks,
                       "launches": run["launches"],
                       "split": {k: v / sweeps for k, v in run["timings"].items()
                                 if k in ("fe_solve", "re_solve", "re_load", "fe_refresh",
                                          "loss")},
                       "rescued_per_chunk": (sum(s["lanes_rescued"] for s in stats)
                                             / len(stats) / sweeps) if stats else None}
        _log(f"18f streamed {label} ({card}): "
             + json.dumps({k: v for k, v in runs[label].items() if k != "launches"}))
    gap = _rel_gap(runs["probe/rescue"]["losses"][-1], runs["unscheduled"]["losses"][-1])
    assert gap <= 1e-5, f"18f: scheduled final loss {gap} rel from unscheduled (limit 1e-5)"
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("fused_glm", "fused_glm_reduce")}
    assert all(v > 0 for v in launches.values()), launches
    return {"summary": dict(runs, final_loss_gap=gap),
            "launches": launches}


def _search_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 18, search and scheduling, printing as it goes. Returns, for
    each kernel this path runs, its launches here and its checks on the
    path's own inputs (P6 on 18(a)'s scheduled fit, B1 and its reduce on
    18(b)'s scheduled step, G1 on 18(d)'s sparse lanes)."""
    t_phase = time.perf_counter()
    base = Path(tempfile.mkdtemp(prefix="search-", dir=Path(__file__).resolve().parent / "build"))
    times: dict = {}
    try:
        t0 = time.perf_counter()
        flagship = _search_flagship(torch, np, seed, dev, card)
        times["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fused = _search_fused(torch, np, seed, dev, card, base)
        times["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        refresh = _search_refresh(torch, np, seed, dev, card, flagship, base)
        times["c"] = time.perf_counter() - t0
        flagship.pop("dataset")
        flagship.pop("train")
        flagship.pop("resident")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        grid = _search_grid(torch, np, seed, dev, card)
        times["d dense, e search"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sparse = _search_sparse(torch, np, seed, dev, card)
        times["d sparse"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        drivers = _search_drivers(torch, np, seed, dev, card, base)
        times["e drivers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stream = _search_stream(torch, np, seed, dev, card)
        times["f"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    path: dict = {}

    def add(name, launches, **extra):
        entry = path.setdefault(name, {"launches": 0})
        entry["launches"] += launches
        entry.update(extra)

    add("packed_glm", flagship["launches"]["packed_glm"] + refresh["p6_launches"]
        + drivers["launches"]["packed_glm"], **flagship["checks"]["packed_glm"])
    add("packed_glm_reduce", flagship["launches"]["packed_glm_reduce"]
        + drivers["launches"]["packed_glm_reduce"], **flagship["checks"]["packed_glm_reduce"])
    for part in (fused, grid, drivers, stream):
        for k in ("fused_glm", "fused_glm_reduce"):
            add(k, part["launches"][k])
    path["fused_glm"].update(fused["checks"]["fused_glm"])
    path["fused_glm_reduce"].update(fused["checks"]["fused_glm_reduce"])
    add("sparse_gather", sparse["launches"]["sparse_gather"], margins=sparse["checks"][0],
        transpose=sparse["checks"][1])
    add("sparse_gather_chunks", sparse["launches"]["sparse_gather_chunks"])
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    seconds = time.perf_counter() - t_phase
    path["fused_glm"]["phase_seconds"] = seconds
    path["fused_glm"]["search"] = {"a": flagship["runs"], "b": fused["summary"],
                                   "c": refresh, "d_dense_e": grid["summary"],
                                   "d_sparse": sparse["summary"], "e_drivers": drivers["summary"],
                                   "f": stream["summary"]}
    _log(f"18. search phase ({card}): {seconds:.2f} s ("
         + ", ".join(f"{k} {v:.2f}" for k, v in times.items()) + ")")
    return path


#: phase 19, telemetry and diagnostics (ROADMAP item 19, step 1): (a) phase
#: 4's generator and widths (2^18 training rows, d=512, with 2^16 held-out
#: rows of the same draw), the diagnostic report of the better of λ ∈ {1, 10}
#: with 8 bootstraps and the default fitting portions; (b) the same report at
#: 2^14 rows with 4 bootstraps, on the card in f32 and on the CPU in f64;
#: (c)-(e) the drivers with their telemetry flags on phase 8's GLM Avro and
#: the flagship's cut Avro; (f) is phase 13's two-rank driver run
TELEMETRY = dict(n=1 << 18, d=512, held_out=1 << 16, lambdas=(1.0, 10.0), iterations=20,
                 bootstraps=8, small_n=1 << 14, small_bootstraps=4, glm_bootstraps=4,
                 serve_requests=512)


def _refit_recorder(train):
    """``train_fn_for_lambda`` of ``build_diagnostic_report`` that keeps each
    refit's (batch, model) in call order: the fitting portions, then the
    bootstraps."""
    refits = []

    def for_lambda(lam):
        def fit(batch):
            model = train(batch, lam)
            refits.append((batch, model))
            return model

        return fit

    return for_lambda, refits


def _report_metrics(report) -> dict:
    """The report's metric values by name: the validation table, the
    learning curves' points and the bootstrap metric summaries."""
    from photon_ml_torch.diagnostics.reporting import LineChart, Table

    out = {}
    for chapter in report.chapters:
        for section in chapter.sections:
            for item in section.items:
                if isinstance(item, LineChart):
                    for series, ys in item.series.items():
                        for x, y in zip(item.x, ys):
                            out[f"{item.title}/{series}/{x}"] = float(y)
                elif isinstance(item, Table) and chapter.title in ("Model summary and metrics",
                                                                   "Bootstrap analysis") \
                        and section.title != "Coefficient stability":
                    for row in item.rows:
                        for h, v in zip(item.headers[1:], row[1:]):
                            out[f"{section.title}/{row[0]}/{h}"] = float(v)
    return out


def _unstable_count(report) -> int:
    for chapter in report.chapters:
        if chapter.title == "Bootstrap analysis":
            text = chapter.sections[1].items[0].body
            return int(text.split(" of ")[0])
    raise AssertionError("the report has no bootstrap chapter")


def _telemetry_diagnostics(torch, np, seed: int, dev, card: str) -> dict:
    """19(a): the diagnostic report at phase 4's width, in memory; B1
    launches equal to the refits' evaluations, exactly; B1 held against
    its plain version on a bootstrap's reweighted batch."""
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.diagnostics.fitting import DEFAULT_PORTIONS
    from photon_ml_torch.diagnostics.hosmer_lemeshow import hosmer_lemeshow
    from photon_ml_torch.diagnostics.independence import kendall_tau_independence
    from photon_ml_torch.diagnostics.metrics import evaluate_model
    from photon_ml_torch.diagnostics.report_builder import build_diagnostic_report
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.ops import fused_glm, objective
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.ops.normalization import (
        NormalizationContext,
        NormalizationType,
        build_normalization,
    )
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    cfg = TELEMETRY
    n, d, nv = cfg["n"], cfg["d"], cfg["held_out"]
    task = TaskType.LOGISTIC_REGRESSION
    x, y = _dataset(np, seed, n + nv, d)
    train = LabeledPointBatch.create(x[:n], y[:n], device=dev)
    val = LabeledPointBatch.create(x[n:], y[n:], device=dev)
    del x, y
    xd = train.features.double()
    norm = build_normalization(NormalizationType.STANDARDIZATION, mean=xd.mean(0),
                               variance=xd.var(0), max_magnitude=xd.abs().amax(0),
                               intercept_index=d - 1)
    norm = NormalizationContext(norm.factors.float(), norm.shifts.float())
    del xd
    opt = OptimizerConfig(OptimizerType.LBFGS, max_iterations=cfg["iterations"])

    def fit(batch, lam):
        return train_glm(batch, task, optimizer=opt, regularization_weights=(lam,),
                         normalization=norm, intercept_index=d - 1)[lam]

    models = train_glm(train, task, optimizer=opt, regularization_weights=cfg["lambdas"],
                       normalization=norm, intercept_index=d - 1)
    metrics = {lam: evaluate_model(m, val) for lam, m in models.items()}
    best = max(metrics, key=lambda lam: metrics[lam]["AUC"])
    for_lambda, refits = _refit_recorder(fit)
    evaluations = [0]
    value_and_gradient = objective.GLMObjective.value_and_gradient

    def counted(self, coefficients, batch):
        evaluations[0] += int(self._kernel_enabled(batch))
        return value_and_gradient(self, coefficients, batch)

    objective.GLMObjective.value_and_gradient = counted
    fused_glm.launches = fused_glm.reduce_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        report = build_diagnostic_report(models, train, val, task=task,
                                         train_fn_for_lambda=for_lambda, best_lambda=best,
                                         num_bootstraps=cfg["bootstraps"], seed=seed,
                                         validation_metrics=metrics)
        torch.cuda.synchronize()
    finally:
        objective.GLMObjective.value_and_gradient = value_and_gradient
    seconds = time.perf_counter() - t0
    launches = {"fused_glm": fused_glm.launches, "fused_glm_reduce": fused_glm.reduce_launches}
    assert len(refits) == len(DEFAULT_PORTIONS) + cfg["bootstraps"], len(refits)
    assert launches["fused_glm"] == evaluations[0] == launches["fused_glm_reduce"] > 0, \
        (launches, evaluations)
    best_model = models[best]
    margins = best_model.score(val.features, val.offsets)
    labels = val.labels.cpu().numpy()
    hl = hosmer_lemeshow(margins.cpu().numpy(), labels, val.weights.cpu().numpy())
    tau = kendall_tau_independence(best_model.mean(margins).cpu().numpy(), labels, seed=seed)
    unstable = _unstable_count(report)
    # B1 on the first bootstrap's reweighted batch (multinomial counts as weights)
    boot = refits[len(DEFAULT_PORTIONS)][0]
    assert not torch.equal(boot.weights, train.weights)
    loss, w = LogisticLoss(), best_model.coefficients.means.float()
    kw = dict(l2_weight=1.0, normalization=norm)
    r = torch.rand(n, device=dev)
    bx = boot.features
    check = _path_check(
        torch, "fused_glm on a bootstrap's reweighted batch",
        lambda: fused_glm.fused_value_and_gradient(loss, w, boot, **kw),
        lambda: fused_glm.fused_value_and_gradient_reference(loss, w, boot, **kw),
        lambda: (torch.matmul(bx, w), torch.matmul(r, bx)), (1e-5, 1e-4),
        n * d * 4 + 12 * n + 8 * d + 8, (n, d))
    out = {"seconds": seconds, "refits": len(refits), "evaluations": evaluations[0],
           "launches": launches, "best_lambda": best,
           "validation_auc": {str(k): v["AUC"] for k, v in metrics.items()},
           "hosmer_lemeshow": {"chi_square": hl.chi_square, "dof": hl.degrees_of_freedom,
                               "p_value": hl.p_value},
           "kendall_tau": {"tau": tau.tau, "p_value": tau.p_value, "samples": tau.num_samples},
           "unstable_coefficients": unstable, "check": check}
    _log(f"19a. diagnostic report, n={n} d={d} ({nv} held out), λ={best:g}, "
         f"{cfg['bootstraps']} bootstraps and {len(DEFAULT_PORTIONS)} fitting portions ({card}): "
         + json.dumps(out))
    return out


def _telemetry_agreement(torch, np, seed: int, dev, card: str) -> dict:
    """19(b): the same report at 2^14 rows, standardized and solved to
    convergence, on the card in f32 and on the CPU in f64, at the CPU's
    best λ: every refit's coefficients within 1e-3·max|w| and every metric
    of the report within 1e-4."""
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.diagnostics.metrics import evaluate_model
    from photon_ml_torch.diagnostics.report_builder import build_diagnostic_report
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.ops.normalization import (
        NormalizationContext,
        NormalizationType,
        build_normalization,
    )
    from photon_ml_torch.optim.optimizer import OptimizerConfig
    from photon_ml_torch.types import TaskType

    cfg = TELEMETRY
    n, d = cfg["small_n"], cfg["d"]
    task = TaskType.LOGISTIC_REGRESSION
    x, y = _dataset(np, seed + 1, n + n // 4, d)
    runs, best = {}, None
    for where, dtype in (("cpu", torch.float64), ("card", None)):
        device = torch.device("cpu") if where == "cpu" else dev
        train = LabeledPointBatch.create(x[:n], y[:n], dtype=dtype, device=device)
        val = LabeledPointBatch.create(x[n:], y[n:], dtype=dtype, device=device)
        xd = train.features.double()
        norm = build_normalization(NormalizationType.STANDARDIZATION, mean=xd.mean(0),
                                   variance=xd.var(0), max_magnitude=xd.abs().amax(0),
                                   intercept_index=d - 1)
        dt = train.features.dtype
        kw = dict(normalization=NormalizationContext(norm.factors.to(dt), norm.shifts.to(dt)),
                  intercept_index=d - 1, optimizer=OptimizerConfig(max_iterations=200))
        del xd

        def fit(batch, lam, kw=kw):
            return train_glm(batch, task, regularization_weights=(lam,), **kw)[lam]

        t0 = time.perf_counter()
        models = train_glm(train, task, regularization_weights=cfg["lambdas"], **kw)
        metrics = {lam: evaluate_model(m, val) for lam, m in models.items()}
        if best is None:
            best = max(metrics, key=lambda lam: metrics[lam]["AUC"])
        for_lambda, refits = _refit_recorder(fit)
        report = build_diagnostic_report(models, train, val, task=task,
                                         train_fn_for_lambda=for_lambda, best_lambda=best,
                                         num_bootstraps=cfg["small_bootstraps"], seed=seed,
                                         validation_metrics=metrics)
        runs[where] = {"seconds": time.perf_counter() - t0,
                       "w": [m.coefficients.means.double().cpu() for _, m in refits],
                       "metrics": _report_metrics(report)}
    cpu, card_run = runs["cpu"], runs["card"]
    assert len(cpu["w"]) == len(card_run["w"]) > cfg["small_bootstraps"]
    gaps = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(card_run["w"], cpu["w"])]
    assert set(cpu["metrics"]) == set(card_run["metrics"]) and cpu["metrics"]
    metric_gap = max(abs(card_run["metrics"][k] - v) for k, v in cpu["metrics"].items())
    out = {"rows": n, "refits": len(gaps), "best_lambda": best,
           "max_coefficient_gap_over_max_w": max(gaps), "coefficient_gaps": gaps,
           "max_metric_gap": metric_gap, "metrics": len(cpu["metrics"]),
           "seconds": {k: v["seconds"] for k, v in runs.items()}}
    _log(f"19b. the report at n={n} d={d} on the card (f32) against the CPU (f64) ({card}): "
         + json.dumps(out))
    assert max(gaps) <= 1e-3, gaps
    assert metric_gap <= 1e-4, metric_gap
    return out


def _glm_avro(np, seed: int, tmp: Path) -> Path:
    """Phase 8's GLM Avro (d=512 at full width, 4,096 + 1,024 rows): the
    copy phase 8 left, else written here."""
    if "drivers_avro" in _SHARED:
        return Path(_SHARED["drivers_avro"]) / "glm"
    pre = _prewritten("drivers-glm")
    if pre is not None:
        return Path(pre["dir"]) / "glm"
    _, glm_jobs = _driver_avro_jobs(np, seed, tmp)
    with _processes().Pool(len(glm_jobs)) as pool:
        pool.map(_write_glm_part, glm_jobs)
    return tmp / "glm"


def _spans_within(trace: dict, phase: str, name: str) -> int:
    """The ``name`` spans of a Chrome trace that start inside the first
    ``phase`` span."""
    events = trace["traceEvents"]
    outer = [e for e in events if e.get("name") == phase][0]
    return sum(1 for e in events if e.get("name") == name
               and outer["ts"] <= e["ts"] <= outer["ts"] + outer["dur"])


def _telemetry_glm_driver(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """19(c): the GLM driver with --enable-diagnostics --num-bootstraps 4
    --telemetry-dir --trace-dir against the same run without them: the
    report files, the journal read back, the training phase's
    solver/iteration spans equal to the journal's per-λ iterations, and
    the model files bitwise."""
    from photon_ml_torch.cli import glm_driver
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.telemetry import read_journal

    glm = _glm_avro(np, seed, tmp)
    on = None if dev.type == "cuda" else dev
    args = ["--input-data-path", str(glm / "train"), "--validation-data-path",
            str(glm / "validation"), "--task-type", "LOGISTIC_REGRESSION",
            "--regularization-weights", "1,10", "--optimizer", "LBFGS", "--max-iterations", "50"]
    flags = ["--enable-diagnostics", "--num-bootstraps", str(TELEMETRY["glm_bootstraps"]),
             "--telemetry-dir", str(tmp / "glm-tel"), "--trace-dir", str(tmp / "glm-tr")]
    seconds, launches = {}, {}
    for name, extra in (("plain", []), ("telemetry", flags)):
        fused_glm.launches = 0
        t0 = time.perf_counter()
        result = glm_driver.main(args + ["--output-dir", str(tmp / f"glm-{name}"), *extra],
                                 device=on)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = fused_glm.launches
    assert result.stage.name == "DIAGNOSED"
    for f in ("diagnostic-report.html", "diagnostic-report.txt"):
        assert (tmp / "glm-telemetry" / f).stat().st_size > 0, f
    rows = read_journal(tmp / "glm-tel" / "run-journal.jsonl")
    kinds = [r["kind"] for r in rows]
    conv = [r for r in rows if r["kind"] == "convergence"]
    assert kinds[0] == "journal_open" and kinds[-1] == "journal_close" \
        and {"config", "heartbeat", "straggler_report", "phase_timing", "metrics"} <= set(kinds)
    assert [r["lambda"] for r in conv] == [1.0, 10.0], conv
    trace = json.loads((tmp / "glm-tr" / "trace-00000.json").read_text())
    spans = _spans_within(trace, "phase/glm train", "solver/iteration")
    iterations = sum(r["iterations"] for r in conv)
    assert spans == iterations > 0, (spans, iterations)
    texts = sorted((tmp / "glm-plain" / "models-text").iterdir())
    same = [(tmp / "glm-telemetry" / "models-text" / f.name).read_bytes() == f.read_bytes()
            for f in texts]
    assert texts and all(same), same
    out = {"seconds": seconds, "b1_launches": launches, "journal_rows": len(rows),
           "iterations": iterations, "solver_iteration_spans": spans,
           "trace_events": len(trace["traceEvents"]), "model_files_bitwise": len(same),
           "report_bytes": (tmp / "glm-telemetry" / "diagnostic-report.html").stat().st_size}
    _log(f"19c. the GLM driver with --enable-diagnostics --num-bootstraps "
         f"{TELEMETRY['glm_bootstraps']} --telemetry-dir --trace-dir ({card}): " + json.dumps(out))
    return out


def _kernel_events(trace: dict, name: str) -> int:
    """Device kernel events of a ``torch.profiler`` Chrome trace whose name
    holds ``name``."""
    return sum(1 for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel" and name in e.get("name", ""))


def _telemetry_game_drivers(torch, np, seed: int, dev, card: str, tmp: Path) -> dict:
    """19(d)-(e): the GAME training driver on the flagship's cut Avro, two
    sweeps, plain, with --telemetry-dir --trace-dir, plain again (the
    ratio's warm baseline), and with those and --profile-dir: coefficient
    files bitwise, the lane loops' host reads
    equal, the profiler's packed_glm_partials_kernel events equal to the
    launch counter; P6 on the driver's fixed effect; then the scoring
    driver with and without telemetry (scores bitwise) and the serve
    driver with it (its counters in the journal)."""
    from dev import torch_kernel_probe
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver, serve_driver
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.optim import common
    from photon_ml_torch.telemetry import read_journal

    avro = _flagship_avro(np, seed, tmp)
    on = None if dev.type == "cuda" else dev
    shards = ["--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
              "--feature-shard-configurations",
              "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
    re_spec = "feature.shard=per_entity,reg.weights=1,optimizer=NEWTON,max.iter=10," \
              "random.effect.type="
    args = ["--input-data-path", str(avro["train"]), "--task-type", "LOGISTIC_REGRESSION",
            *shards, "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--coordinate-configurations", f"name=per_user,{re_spec}userId",
            "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
            "--coordinate-descent-iterations", "2"]
    telemetry = ["--telemetry-dir", str(tmp / "game-tel"), "--trace-dir", str(tmp / "game-tr")]
    runs = {}
    # the plain run twice, around the traced one: the first also warms up
    for name, extra in (("plain", []), ("telemetry", telemetry), ("plain again", []),
                        ("profiled", ["--telemetry-dir", str(tmp / "game-tel-p"), "--trace-dir",
                                      str(tmp / "game-tr-p"), "--profile-dir",
                                      str(tmp / "game-prof")])):
        for counter in ("packed_launches", "columns_launches", "reduce_launches"):
            setattr(packed_glm, counter, 0)
        reads = common.lane_host_reads
        t0 = time.perf_counter()
        game_training_driver.main(args + ["--root-output-dir",
                                          str(tmp / f"game-{name.replace(' ', '-')}"),
                                          *extra], device=on)
        torch.cuda.synchronize()
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "lane_host_reads": common.lane_host_reads - reads,
                      "p6_launches": packed_glm.packed_launches + packed_glm.columns_launches}
    for name in ("telemetry", "plain again", "profiled"):
        assert runs[name]["lane_host_reads"] == runs["plain"]["lane_host_reads"], runs
        for f in sorted((tmp / "game-plain" / "best").rglob("*")):
            if f.is_file():
                rel = f.relative_to(tmp / "game-plain" / "best")
                got = tmp / f"game-{name.replace(' ', '-')}" / "best" / rel
                assert got.read_bytes() == f.read_bytes(), \
                    (name, rel)
    profiles = sorted((tmp / "game-prof").glob("*.json"))
    assert len(profiles) == 1, profiles
    traced = _kernel_events(json.loads(profiles[0].read_text()), "packed_glm_partials_kernel")
    runs["profiled"]["profiler_kernel_events"] = traced
    assert traced == runs["profiled"]["p6_launches"] > 0, runs["profiled"]
    rows = read_journal(tmp / "game-tel" / "run-journal.jsonl")
    beats = [r for r in rows if r["kind"] == "heartbeat"]
    assert [b["sweep"] for b in beats] == [1, 2], beats
    if dev.type == "cuda":  # the allocator's bytes, on a CUDA run only
        assert all("hbm_bytes" in b for b in beats), beats
    trace = json.loads((tmp / "game-tr" / "trace-00000.json").read_text())
    assert _spans_within(trace, "phase/train config 0", "solver/iteration") > 0

    # P6 on the driver's fixed-effect inputs, read back from its training Avro
    maps = IndexMap.load_directory(tmp / "game-plain" / "index-maps")
    model = load_game_model(tmp / "game-plain" / "best", maps, device=dev)
    shard_cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
                 "per_entity": FeatureShardConfiguration(feature_bags=("perEntityFeatures",),
                                                         has_intercept=False)}
    ds = read_merged(avro["train"], shard_cfg, index_maps=maps,
                     random_effect_id_columns=("itemId", "userId"),
                     entity_vocabs={m.random_effect_type: m.entity_keys
                                    for m in model.models.values()
                                    if hasattr(m, "entity_keys")}, device=dev).dataset
    x = ds.feature_shards["global"]
    n = x.shape[0]
    w = model.get("fixed").glm.coefficients.means.float().contiguous()
    aux = packed_glm.pack_aux(ds.labels, ds.offsets + model.score(ds) - x @ w, ds.weights)
    r = torch.rand(n, device=dev)
    loss = LogisticLoss()
    check = _path_check(
        torch, "packed_glm on the traced GAME driver's fixed effect",
        lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
        lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
        lambda: (torch.matmul(x, w), torch.matmul(r, x)), torch_kernel_probe.limits("float32"),
        x.shape[0] * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8, x.shape)
    del ds, x, aux, r

    # (e) scoring with and without telemetry, then the serve driver with it
    score = ["--input-data-path", str(avro["validation"]), "--model-input-dir",
             str(tmp / "game-plain" / "best"), *shards, "--evaluators", "AUC"]
    seconds = {}
    for name, extra in (("plain", []), ("telemetry", ["--telemetry-dir", str(tmp / "score-tel"),
                                                      "--trace-dir", str(tmp / "score-tr")])):
        t0 = time.perf_counter()
        game_scoring_driver.main(score + ["--output-dir", str(tmp / f"score-{name}"), *extra],
                                 device=on)
        seconds[f"score {name}"] = time.perf_counter() - t0
    parts = sorted((tmp / "score-plain" / "scores").iterdir())
    assert parts and all((tmp / "score-telemetry" / "scores" / p.name).read_bytes()
                         == p.read_bytes() for p in parts)
    srows = read_journal(tmp / "score-tel" / "run-journal.jsonl")
    summary = [r for r in srows if r["kind"] == "scoring_summary"][0]
    assert summary["num_scored"] == avro["held_out"], summary
    t0 = time.perf_counter()
    served = serve_driver.main([
        "--requests-avro", str(avro["validation"]), "--model-input-dir",
        str(tmp / "game-plain" / "best"), "--output-dir", str(tmp / "served"), *shards,
        "--request-rows", str(SERVING["driver_request_rows"]), "--num-requests",
        str(TELEMETRY["serve_requests"]), "--telemetry-dir", str(tmp / "serve-tel"),
        "--trace-dir", str(tmp / "serve-tr")], device=on)
    seconds["serve telemetry"] = time.perf_counter() - t0
    vrows = read_journal(tmp / "serve-tel" / "run-journal.jsonl")
    snap = [r for r in vrows if r["kind"] == "metrics"][0]["snapshot"]
    assert snap["counters"]["serve/requests"] >= TELEMETRY["serve_requests"] \
        and snap["histograms"]["serve/latency_ms"]["count"] >= TELEMETRY["serve_requests"] \
        and [r for r in vrows if r["kind"] == "serving_summary"], snap
    vtrace = json.loads((tmp / "serve-tr" / "trace-00000.json").read_text())
    assert {"serve/batch", "serve/score"} <= {e["name"] for e in vtrace["traceEvents"]}
    out = {"rows": [avro["n"], avro["held_out"]], "runs": runs, "seconds": seconds,
           "telemetry_over_plain": runs["telemetry"]["seconds"]
           / runs["plain again"]["seconds"],
           "profiled_over_plain": runs["profiled"]["seconds"] / runs["plain again"]["seconds"],
           "heartbeats": len(beats), "scores_bitwise": len(parts),
           "serve": {k: served[k] for k in ("num_requests", "scores_per_sec", "latency_ms_p50",
                                            "latency_ms_p95", "replay_compiles")},
           "p6_check": check}
    _log(f"19d-e. the GAME training driver on {avro['n']} + {avro['held_out']} flagship rows, "
         f"plain / --telemetry-dir --trace-dir / and --profile-dir; the scoring and serve "
         f"drivers with telemetry ({card}): " + json.dumps(out))
    return out


def _telemetry_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 19, telemetry and diagnostics, printing as it goes. Returns,
    for each kernel this path runs, its launches here (B1 in (a)'s report
    and (c)'s traced GLM driver, P6 in (d)'s traced GAME driver runs) and
    its checks on the path's own inputs."""
    t_phase = time.perf_counter()
    base = Path(tempfile.mkdtemp(prefix="telemetry-",
                                 dir=Path(__file__).resolve().parent / "build"))
    times: dict = {}
    try:
        t0 = time.perf_counter()
        diag = _telemetry_diagnostics(torch, np, seed, dev, card)
        times["a"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        agreement = _telemetry_agreement(torch, np, seed, dev, card)
        times["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        glm = _telemetry_glm_driver(torch, np, seed, dev, card, base)
        times["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        game = _telemetry_game_drivers(torch, np, seed, dev, card, base)
        times["d-e"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    ranks = _SHARED.get("partitioned_traces")
    if ranks is not None:
        _log(f"19f. phase 13's two-rank --partitioned-io GAME driver run with --trace-dir "
             f"--telemetry-dir ({card}): " + json.dumps(ranks))
    path = {"fused_glm": dict(diag["check"], launches=diag["launches"]["fused_glm"]
                              + glm["b1_launches"]["telemetry"],
                              evaluations=diag["evaluations"]),
            "packed_glm": dict(game["p6_check"], launches=game["runs"]["telemetry"]["p6_launches"]
                               + game["runs"]["profiled"]["p6_launches"])}
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    seconds = time.perf_counter() - t_phase
    path["fused_glm"]["phase_seconds"] = seconds
    path["fused_glm"]["telemetry"] = {
        "a": {k: v for k, v in diag.items() if k != "check"}, "b": agreement, "c": glm,
        "d_e": {k: v for k, v in game.items() if k != "p6_check"}, "f": ranks}
    _log(f"19. telemetry phase ({card}): {seconds:.2f} s ("
         + ", ".join(f"{k} {v:.2f}" for k, v in times.items()) + ")")
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from photon_ml_torch import build
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.ops import fused_glm, losses
    from photon_ml_torch.ops.normalization import (
        NormalizationContext,
        NormalizationType,
        build_normalization,
    )
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    # the fork server every process of the script starts from, importing
    # torch and the port's modules while the kernels build
    from multiprocessing import forkserver

    _processes()
    forkserver.ensure_running()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    _log(card)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    _log(f"build: {json.dumps(built)} ({time.perf_counter() - t0:.2f} s); B1's tile plan at "
         f"d=512: f32 {fused_glm.tile_plan(512, torch.float32)}, bf16 "
         f"{fused_glm.tile_plan(512, torch.bfloat16)}; one pass to d=8192: "
         f"{fused_glm.tile_plan(8192, torch.float32)}")

    # the files phases share (the Avro written in the background from here
    # on, read from phase 8 on)
    os.makedirs(Path(__file__).resolve().parent / "build", exist_ok=True)
    shared = Path(tempfile.mkdtemp(prefix="shared-", dir=Path(__file__).resolve().parent
                                   / "build"))
    atexit.register(shutil.rmtree, shared, True)
    _SHARED["dir"] = shared
    _start_prewrites(np, args.seed)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    worst = _kernel_cases(torch, fused_glm, losses, LabeledPointBatch, NormalizationContext,
                          args.seed)
    _log(f"kernel checks: {json.dumps(worst)} ({time.perf_counter() - t0:.2f} s)")

    # 4. the slice at n=2^18, d=512
    n, d = 1 << 18, 512
    t_dense = t0 = time.perf_counter()
    x_np, y_np = _dataset(np, args.seed, n, d)
    batch = LabeledPointBatch.create(x_np, y_np, device=dev)
    batch16 = LabeledPointBatch.create(x_np, y_np, dtype=torch.bfloat16, device=dev)
    del x_np
    xd = batch.features.double()
    norm = build_normalization(
        NormalizationType.STANDARDIZATION, mean=xd.mean(0), variance=xd.var(0),
        max_magnitude=xd.abs().amax(0), intercept_index=d - 1)
    norm = NormalizationContext(norm.factors.float(), norm.shifts.float())
    del xd
    torch.cuda.synchronize()
    _log(f"dataset n={n} d={d}: {time.perf_counter() - t0:.2f} s")

    task = TaskType.LOGISTIC_REGRESSION
    solves = []

    def run(label, b, use_kernel=None, **kw):
        marks = {"t": time.perf_counter(), "launches": fused_glm.launches}

        def on_solve(lam, result):
            torch.cuda.synchronize()
            now = time.perf_counter()
            hist = result.value_history[: result.iterations + 1].double().cpu().numpy()
            solves.append({"run": label, "lambda": lam, "seconds": now - marks["t"],
                           "evaluations": fused_glm.launches - marks["launches"],
                           "iterations": result.iterations, "reason": result.reason,
                           "value": float(result.value), "history": hist})
            marks.update(t=now, launches=fused_glm.launches)

        return train_glm(b, task, normalization=norm, intercept_index=d - 1,
                         use_kernel=use_kernel, on_solve=on_solve, **kw)

    lbfgs20 = OptimizerConfig(OptimizerType.LBFGS, max_iterations=20)
    fused_glm.launches = fused_glm.reduce_launches = 0
    models = run("lbfgs", batch, optimizer=lbfgs20, regularization_weights=(1.0, 10.0))
    run("owlqn", batch, optimizer=lbfgs20, regularization_weights=(1.0,), elastic_net_alpha=0.5)
    run("tron", batch, optimizer=OptimizerConfig(OptimizerType.TRON, max_iterations=5,
                                                 tolerance=1e-5),
        regularization_weights=(1.0,))
    run("lbfgs_bf16", batch16, optimizer=lbfgs20, regularization_weights=(1.0,))
    torch.cuda.synchronize()
    launches, reduce_launches = fused_glm.launches, fused_glm.reduce_launches
    iterations = sum(s["iterations"] for s in solves)
    _log(f"main path: {len(solves)} solves, {iterations} iterations, {launches} fused_glm "
         f"launches, {reduce_launches} reduce launches")
    assert launches >= iterations > 0 and reduce_launches == launches
    for s in solves:
        h = s["history"]
        assert np.isfinite(h).all() and (np.diff(h) <= 0).all(), f"not decreasing: {s['run']}"
        assert s["evaluations"] > 0

    # the L-BFGS path again through the closed form: same final values
    kernel_values = [s["value"] for s in solves if s["run"] == "lbfgs"]
    run("lbfgs_closed_form", batch, use_kernel=False, optimizer=lbfgs20,
        regularization_weights=(1.0, 10.0))
    assert fused_glm.launches == launches  # the closed form launches no kernel
    closed_values = [s["value"] for s in solves if s["run"] == "lbfgs_closed_form"]
    for kv, cv in zip(kernel_values, closed_values):
        assert abs(kv - cv) <= 1e-4 * abs(cv), f"kernel {kv} vs closed form {cv}"

    scores = models[1.0].score(batch.features)
    assert scores.shape == (n,) and bool(torch.isfinite(scores).all())
    auc = local_metrics.area_under_roc_curve(scores, y_np)
    assert 0.6 < auc <= 1.0, auc

    # a small problem solved to convergence: card (kernel) against CPU (f64)
    xs, ys = _dataset(np, args.seed + 1, 4096, 64)
    small = {}
    for where, dtype in (("cuda", None), ("cpu", torch.float64)):
        b = LabeledPointBatch.create(xs, ys, dtype=dtype, device=where)
        small[where] = train_glm(b, task, regularization_weights=(1.0,))[1.0] \
            .coefficients.means.double().cpu()
    gap = float((small["cuda"] - small["cpu"]).abs().max())
    scale = float(small["cpu"].abs().max())
    _log(f"small problem n=4096 d=64: card vs cpu f64 max |dw| {gap:.3g} (max |w| {scale:.3g})")
    assert gap <= 1e-3 * scale

    # 6. times at the main path's shape and inputs (logistic, standardization):
    # "ms"/"plain_ms"/"library_ms" are device times (CUDA graph replay),
    # "eager_ms" the time of one call as the solver loop makes it
    loss = losses.LogisticLoss()
    w = models[1.0].coefficients.means.float()
    kw = dict(l2_weight=1.0, normalization=norm)
    timed = {}
    for b, label in ((batch, "float32"), (batch16, "bfloat16")):
        x = b.features
        nbytes = n * d * x.element_size() + 12 * n + 4 * d + 4 * d + 8
        bound, by = _bound_ms(nbytes, 4.0 * n * d)
        kernel = lambda: fused_glm.fused_value_and_gradient(loss, w, b, **kw)  # noqa: E731
        wx, r = w.to(x.dtype), torch.rand(n, device=dev).to(x.dtype)
        timed[label] = {
            "ms": _device_ms(torch, kernel),
            "plain_ms": _device_ms(
                torch, lambda: fused_glm.fused_value_and_gradient_reference(loss, w, b, **kw)),
            "bound_ms": bound, "bound_by": by,
            # the closed form's two products X@w and r'X, in X's dtype
            "library_ms": _device_ms(torch, lambda: (torch.matmul(x, wx), torch.matmul(r, x))),
            "eager_ms": _eager_ms(torch, kernel),
            "partials_ms": _device_ms(torch, lambda: fused_glm.fused_partials(
                loss, x, b.labels, b.offsets, b.weights, w, None)),
        }
    b1_args = (loss, batch.features, batch.labels, batch.offsets, batch.weights, w, None)
    line = {"kernels": [
        {"name": "fused_glm", "route": "cuda", "source": "photon_ml_torch/csrc/fused_glm.cu",
         "replaces": "photon_ml_tpu/ops/pallas_glm.py:128", "launches": launches,
         "max_abs_err": worst["main_grad_abs"], **timed["float32"], "shape": [n, d],
         "dtype": "float32", "bf16": timed["bfloat16"]},
        {"name": "fused_glm_reduce", "route": "cuda",
         "source": "photon_ml_torch/csrc/glm_tile.cuh",
         "replaces": "photon_ml_tpu/ops/pallas_glm.py:128", "launches": reduce_launches,
         **_reduce_entry(torch, "fused_glm_reduce", lambda: fused_glm.fused_partials(*b1_args),
                         fused_glm.reduce_partials, fused_glm.reduce_partials_reference)},
    ]}
    line["kernels"].extend(_wide_b1_entries(torch, fused_glm, loss, args.seed, card))
    for s in solves:
        _log(f"solve {s['run']} λ={s['lambda']:g}: {s['iterations']} iterations, reason "
             f"{s['reason']}, {s['evaluations']} evaluations in {s['seconds']:.4f} s "
             f"({s['evaluations'] / s['seconds']:.1f} evaluations/s), value {s['value']:.8g}")
    _log(f"AUC (λ=1, training data): {auc:.6f}")
    _log(f"dense phases (4 and 6): {time.perf_counter() - t_dense:.2f} s")
    del batch, batch16, b1_args, models, scores
    torch.cuda.empty_cache()

    # 5. the sparse slice (its times are device times, as above)
    t0 = time.perf_counter()
    sparse_entries = _sparse_slice(torch, np, args.seed, dev, card)
    _log(f"sparse phases: {time.perf_counter() - t0:.2f} s")
    line["kernels"].extend(sparse_entries)

    # 7. the GAME slice
    t0 = time.perf_counter()
    line["kernels"].extend(_game_slice(torch, np, args.seed, dev, card))
    _log(f"GAME phases: {time.perf_counter() - t0:.2f} s")

    # 7b. the projected GAME slice, its launches and kernel checks as its own path
    t0 = time.perf_counter()
    projected_path = _projected_slice(torch, np, args.seed, dev, card)
    _log(f"projected GAME phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in projected_path.items()}))

    # 8. the drivers: each kernel of that path with its launches there, and
    # its check and times on that path's own inputs
    t0 = time.perf_counter()
    driver_path = _driver_slice(torch, np, args.seed, dev, card)
    _log(f"driver phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in driver_path.items()}))

    # 9. the sparse GAME slice: its launches, and compact scoring held on its
    # own inputs as a kernels-line entry of its own
    t0 = time.perf_counter()
    sparse_game_path, compact_entry = _sparse_game_slice(torch, np, args.seed, dev, card)
    line["kernels"].append(compact_entry)
    _log(f"sparse GAME phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in sparse_game_path.items()}))

    # 10. matrix factorization: its launches and kernel checks as its own path
    t0 = time.perf_counter()
    mf_path = _mf_slice(torch, np, args.seed, dev, card)
    _log(f"MF GAME phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in mf_path.items()}))
    # 11. the fused GAME training program: its launches and kernel checks as
    # its own path
    t0 = time.perf_counter()
    fused_path = _fused_slice(torch, np, args.seed, dev, card)
    _log(f"fused GAME phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in fused_path.items()}))
    # 12. the fused program over a data-axis mesh: one rank, two ranks,
    # scoring and the drivers; its launches and kernel checks as its own path
    t0 = time.perf_counter()
    mesh_path = _mesh_slice(torch, np, args.seed, dev, card)
    _log(f"mesh phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in mesh_path.items()}))
    # 13. partitioned I/O: each rank decodes its slice and trains and scores
    # its own block; its launches and kernel checks as its own path
    t0 = time.perf_counter()
    partitioned_path = _partitioned_slice(torch, np, args.seed, dev, card)
    _log(f"partitioned phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in partitioned_path.items()}))
    # 14. the model axis: the column-sharded GLM, the fused program with the
    # fixed effect feature-sharded, scoring and the drivers; its launches and
    # kernel checks as its own path
    t0 = time.perf_counter()
    model_path = _model_axis_slice(torch, np, args.seed, dev, card)
    _log(f"model-axis phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in model_path.items()}))
    # 15. streamed GLM solves, checkpoints and recovery: its launches and its
    # kernel checks on chunk inputs as its own path
    t0 = time.perf_counter()
    stream_path = _stream_slice(torch, np, args.seed, dev, card)
    _log(f"stream phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in stream_path.items()}))
    # 16. streamed GAME, two ranks and coordinated recovery: its launches and
    # its kernel checks on a GAME chunk as its own path
    t0 = time.perf_counter()
    stream_game_path = _stream_game_slice(torch, np, args.seed, dev, card)
    _log(f"stream GAME phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in stream_game_path.items()}))
    # 17. serving: the resident scorer's captured graphs, the micro-batching
    # server, hot swaps and the serve driver; its launches and its kernel
    # checks inside the captured path as its own path
    t0 = time.perf_counter()
    serving_path = _serving_slice(torch, np, args.seed, dev, card)
    _log(f"serving phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in serving_path.items()}))
    # 18. search and scheduling: the lane scheduler on the GAME paths, the
    # refresh, the λ-grid and tournament lanes, the model search and the
    # drivers' options; its launches and kernel checks as its own path
    t0 = time.perf_counter()
    search_path = _search_slice(torch, np, args.seed, dev, card)
    _log(f"search phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in search_path.items()}))
    # 19. telemetry and diagnostics: the diagnostic report, its agreement
    # with the CPU, the drivers with their telemetry flags; its launches and
    # kernel checks as its own path
    t0 = time.perf_counter()
    telemetry_path = _telemetry_slice(torch, np, args.seed, dev, card)
    _log(f"telemetry phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in telemetry_path.items()}))
    for key, path in (("projected_path", projected_path), ("driver_path", driver_path),
                      ("sparse_game_path", sparse_game_path), ("mf_path", mf_path),
                      ("fused_path", fused_path), ("mesh_path", mesh_path),
                      ("partitioned_path", partitioned_path), ("model_path", model_path),
                      ("stream_path", stream_path), ("stream_game_path", stream_game_path),
                      ("serving_path", serving_path), ("search_path", search_path),
                      ("telemetry_path", telemetry_path)):
        for entry in line["kernels"]:
            if entry["name"] in path:
                entry[key] = path[entry["name"]]
        assert all(any(e["name"] == k for e in line["kernels"]) for k in path), key
    _log(card)
    _log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
