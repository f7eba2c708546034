#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pase_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:
  1. device  — a CUDA device (else exit 1), its nvidia-smi name and power
               limit, TF32 off for matmuls and cuDNN.
  2. build   — the QRNN kernels (pase_tpu_torch/csrc/qrnn_pool.cu) and the
               stride-1 conv kernels (csrc/conv_s1_tc.cu: conv_s1_tc, bf16,
               and conv_s1_tf32x3, float32, both on the tensor cores), nvcc
               for sm_90a, from the sources of this checkout, both builds
               at once.
  3. kernel  — the serving forward kernels against the plain PyTorch
               version on the card at each of QRNN_SHAPES: the split
               kernel (qrnn_pool_fwd_split), the few-lane one
               (qrnn_pool_fwd_few), the segmented serial one
               (qrnn_pool_fwd_seg), the one-thread-a-lane one
               (qrnn_pool_fwd) and the chunked eval one
               (qrnn_pool_fwd_eval) unseeded, max|dh|, max|dc_T| <= 1e-5;
               the eval, the split and the few-lane kernels also within
               5e-7 of the plain versions of their algebra at the
               library's chunking and tiling, two calls bit for bit;
               qrnn_pool c0-seeded,
               and block-streamed == full bit for bit on that seeded
               route; the two serial kernels equal bit for bit, seeded
               and unseeded; the time of each (CUDA graphs of 20
               launches, so no host time between them; the five in
               turns) beside the byte bound, and the route an unseeded
               and a seeded call take there (the routed kernel against
               the kernel the unseeded route takes without the split
               kernel: the eval one on its lanes and steps, else the
               few-lane one); an empty kernel's time in the same graphs,
               the launch floor; then the split kernel at
               QRNN_GATE_SHAPES, on gates whose carries decay slowly
               (f less 6) and never (f = 0 from the second step): within
               1e-5 of the plain version and 5e-7 of its algebra, two
               calls bit for bit, and its time in turns with the few-lane
               kernel's. At FEW_SHAPES (B = 1 of 200, 800 and 1000
               steps, [2,1500,512], the serving batch [8,1000,512]), on
               random gates and at FEW_GATE_SHAPES on slow and frozen
               ones, the few-lane kernel in turns with the streaming
               floor (cuda_qrnn.stream_floor: y read once, h written
               once, no carry) and the empty kernel, and its time as a
               ratio to both floors. (The kernel the few-lane one
               replaced is timed beside it by ``python -m
               pase_tpu_torch.kernel_variants fewlane --against`` an
               earlier qrnn_pool.cu, not here.)
  4. encoder — PASE+ at full width (cfg/frontend/PASE+.cfg), seeded
               weights: the (1,1,100000) -> (1,256,625) contract, a
               (8,1,160000) batch, the same batch on the CPU (plain path)
               within 2e-4 of its largest value, forward time. Then, off
               the serving path's count, the registered QRNN operator
               against the direct launch it wraps, in this process: host us
               per call, and the forward at (1,1,160000) and (8,1,160000)
               through each in alternating pairs (medians, and a bootstrap
               95 % interval of the paired difference).
  5. serve   — forward-chunk (the port's CLI entry point) over four wavs
               with the seeded weights saved as a native .npz.
  6. kernel-train — the training kernels qrnn_pool_fwd_train and
               qrnn_pool_bwd (the chunked pair) against the plain
               version's autograd and against the chunked plain versions
               (their algebra, at their chunking) at every shape of
               TRAIN_QRNN_SHAPES: zero-seeded, c0-seeded, nonzero dc_T,
               both; h, c, c_T and dc0 within 1e-5, dy within 1e-5 of
               max(1, max|dy_plain|); two calls bit for bit; the time of
               each (CUDA graphs of 20 launches: the kernels are shorter
               than their wrappers' host time at the few-lane shapes) and
               its bound.
  7. train   — one PASE+ / workers+ train step at full width (batch
               2 x 16000) on the card against the same weights and batch
               on the CPU (plain path): per-worker losses within 1e-4
               relative; PReLU inputs of opposite sign on the two devices
               only within 1e-5 of their module's largest from 0; with the
               CPU's PReLUs on the card's side of that kink, the card's
               gradient within 1e-3 of the CPU's largest per parameter
               group, and per leaf within 1e-3 of the CPU leaf's largest
               (leaves above 1e-3 of their group's largest). Then the
               training CLI, ``python -m pase_tpu_torch.train
               --synthetic`` at batch 32 x 32000 for one epoch (CLI_STEPS
               steps, a 1-batch eval, FE_e0.npz), and a torch.profiler
               split of three further steps.
  8. train-dist — bench.py's step (pase_tpu_torch/bench.py's build and
               measure): PASE+ / workers+ at batch 32 x 32000 with ZNorm
               statistics from compute_stats (2 synthetic batches of 8)
               and the distortion stack (reverb .5, overlap .1, noise .4,
               clip .2, chop .2) on synthetic assets seeded as bench.py
               makes them, in bf16 (bench.py's compute_dtype) and in
               float32; 3 warm-up steps, 3 trials of 20: median steps/s,
               audio-s/s, the trials' spread, and the same trainer's
               steps/s with the stack off; every loss finite; a
               torch.profiler split with pase.prepare for each; and
               apply_distortions on the card against the CPU with the same
               draws, max|diff| <= 1e-5 of max|out| (the bench stack, and
               all nine stages at p = 1).
  9. conv    — python -m pase_tpu_torch.conv_proto's seven trunk layers at
               batch 96, in bf16 through conv_s1_tc (within 2^-7 of
               max|y_plain|) and in float32 through conv_s1_tf32x3
               (within 1e-5 of max|y_plain|); per layer the kernel's,
               cuDNN's and the plain version's ms, TFLOP/s and share of
               the bound (float32: also the bound at the CUDA cores'
               67 TFLOP/s).
 10. trajectory — pase_tpu_torch/trajectory.py's 40-step gate on the card
               in float32 (TF32 off) and in bf16 against the JAX runs of
               tests/fixtures/torch_port_trajectory.json: per worker and
               'total', mean relative deviation <= 1 % or <= 2x the JAX
               run's own one-ulp floor; the table is printed.
 11. resume  — in a process of its own under
               torch.use_deterministic_algorithms (warnings recorded, not
               raised; CUBLAS_WORKSPACE_CONFIG set): the gate's trainer
               trains 2 steps, saves, a new Trainer resumes and trains 2
               more, against 4 uninterrupted steps run twice (the card's
               own run-to-run spread), in float32 and bf16. Bit for bit
               where the uninterrupted runs agree bit for bit; else within
               twice their spread, with the ops that have no deterministic
               implementation named.
 12. disk    — disk-fed training (no corpus needed on disk: the phase
               writes its own): a seeded synthetic corpus of DISK_TRAIN_S
               (900) s of 1-16 s utterances in LibriSpeech's layout
               (pase_tpu_torch/data/synthetic_corpus.py, some shorter than
               the 2 s chunk) and 2 min of valid audio; its ZNorm pickle
               from ``python -m pase_tpu_torch.make_trainset_statistics``;
               then ``python -m pase_tpu_torch.train --data_root
               --data_cfg`` at PASE+ / workers+, batch 32 x 32000, bf16,
               bench.py's distortion stack (written as a --dtrans_cfg), one
               epoch with each feed: one host ChunkBatcher, 4 host
               threads, 4 threads with the int16 wire, the device corpus.
               Per feed: steps/s against phase 8's bf16 rate, the host's
               wait for the next batch and the staging's host time per
               step, every loss finite; the device corpus's bytes and
               build time; its rows against the wav files bit for bit at
               starts read back from the card; a second call with --epoch
               2 resumes at step bpe and draws the uninterrupted feed's
               batch there bit for bit.
 13. stream  — the streaming encoder (pase_tpu_torch/streaming.py), PASE+
               at full width, seeded weights: B=1 and B=8 over 10 s of
               audio in 1 s pushes and in 100 ms pushes; the two chunkings
               bit for bit equal, each within rtol 1e-3 / atol 2e-4 of the
               offline encoder (the max relative difference printed);
               forward-chunk --streaming over phase 5's four wavs against
               the offline encoder of each whole file (the same bound); the
               median ms per 1 s push at B=1 and the real-time factor; a
               steady 1 s push profiled (device busy ms, K1's ms and share
               of it) with K1 as the segmented kernel and as the
               one-thread-a-lane one (the route forced), in turns; the two
               seeded at [1,100,512], [8,100,512], [1,10,512] and
               [8,10,512], bit for bit equal, each timed in turns in CUDA
               graphs at T and at T=1 beside its byte bound and its
               latency floor (the faster kernel at T=1 plus T-1 dependent
               FMAs at the SM's clock).
 14. export  — ``python -m pase_tpu_torch.util_scripts export`` on the card
               (buckets 8000/16000/32000/64000, a streaming chunk of 16000;
               the seconds per program printed), then serve-encode over the
               four wavs, single and with --batch_size 4, within 2e-5 of
               forward-chunk --chunk_size 64000 (requests/s of each); the
               streaming artifact against the in-process stream at the same
               chunk, bit for bit (B=1 and 4); the 64000 bucket at B=40,
               above the few-lane route's lanes, within 2e-5 of the offline
               encoder; and a narrow artifact exported on the CPU, served on
               the card (moved by the loader), within 2e-5 of its CPU
               frames.
 15. overlap — one full-width step of workers+ plus an overlap head (BCE on
               the frame label of the distortion stack at overlap_p 1.0,
               bench.py's assets; batch 2 x 16000) on the card and on the
               CPU, the same weights, batch and draws: per-worker losses
               within 1e-4 relative; the training kernels once per QRNN
               layer on the card.
 16. variants-train — (a) cfg/frontend/PASE+_resblocks_VQ8192.cfg (the
               residual trunk, an 8192-code VQ-EMA quantizer) with
               workers+, one 2 x 16000 step on the card and the CPU, the
               same weights and batch: losses ('vq' included) within 1e-4
               relative, gradients within 1e-3 of each group's largest,
               with the CPU's PReLU signs and near-tie VQ codes (top-2
               margin within 1e-5 of |x|^2 + |e|^2) taken from the card
               (grad_parity.prelu_signs, vq_codes), the codes equal
               outside ties, the forced codes counted; (b) its training
               CLI at 32 x 32000, bf16, the bench stack, one epoch:
               steps/s beside phase 8's bf16 rate, every loss finite,
               vq_perplexity, a torch.profiler split with the quantizer's
               own span; (c) cfg/frontend/PASE.cfg with
               cfg/workers/workers.cfg (the PASE v0.1 bank: SPC, LIM, GIM,
               cchunk, lps, mfcc, prosody), one 2 x 16000 step with an
               injected spc_idx card vs CPU, then its CLI for one epoch at
               32 x 32000 (float32): steps/s, every loss finite; (d)
               workers+ plus a Gap head, one step with an injected gap_idx
               card vs CPU.
 17. variants-serve — the VQ encoder, seeded weights: (8,1,160000) on the
               card against the CPU within 2e-4 of max|y| with the CPU's
               near-tie codes taken from the card, the forward's ms and a
               profile of it (the quantizer beside the trunk);
               forward-chunk over phase 5's four wavs; streams at B=1 and
               B=8 in 1 s and 100 ms pushes, the two chunkings bit for bit
               equal, each within rtol 1e-3 / atol 2e-4 of the offline
               encoder where the codes agree (codes may differ only at the
               offline encoder's ties; counted); ms per 1 s push at B=1
               and a steady push profiled as in phase 13;
               export (buckets 32000 and 64000, a 16000 streaming chunk)
               and serve-encode over the four wavs within 2e-5 of forward-chunk
               --chunk_size 64000, the streaming artifact bit for bit
               equal to the in-process stream.
 18. gan     — the GAN workers: (a) one full-width PASE+ / workers+ step
               with recipes/run_pase_plus_gan.sh's gan_cfg (wave LSGAN on
               cchunk), batch 2 x 16000, card vs CPU with the same model
               and D weights: losses (cchunk_g and d_loss included) within
               1e-4 relative, gradients under phase 7's rule, D's
               gradients within 1e-3 of their largest, D's parameters
               after the step within 1e-4 of their largest where D's
               gradient is above 1e-4 of its leaf's largest (else within
               2 lr: Adam's first step), u within 1e-5; (b) the same for
               the z GAN with the cchunk prior; (c) the recipe's command
               line through the CLI with --synthetic (its corpus,
               statistics and distortion flags dropped: their files are
               not in the repository), batch 16 x 32000, bf16, one epoch,
               then the same without --gan_cfg: steps/s of both, every loss
               finite; (f) a torch.profiler split of three GAN steps, D's
               span pase.discriminator against the rest; (d) the GAN train
               state saved, resumed by a new Trainer bit for bit (D's
               leaves too), and the next step of both within 1e-4; (e)
               PASE+ with snorm and with wnorm FeBlocks (the sinc layer
               off: it takes no reparameterization) at (8,1,160000), card
               vs CPU within 2e-4 of max|y|.
 19. probes  — the downstream probes (pase_tpu_torch/probes): (a) the
               transfer gate's speaker corpus at its defaults (30 speakers
               x 28 utterances of 2 s); (b) the PASE+ extractor at batch 1
               (the 1600-sample bucket, avg_concat) on 16 of them, card vs
               CPU within 2e-4 of max|y|, its ms per utterance and
               audio-s/s, a torch.profiler split; (c) ``python -m
               pase_tpu_torch.run_probe`` in this process, seeded PASE+
               weights saved as a native .npz: utt with
               recipes/probes/run_spkid_minivox.sh's flags over the whole
               corpus (its MLP's training time apart), knn, kfold --folds
               3, and frames and timit-full (cfg/probes/MLP_PASE.cfg, 4
               epochs, decoder.cfg with a fake decode_dnn.sh: rc 0, its
               WER read back) on a TIMIT-shaped corpus of 36 utterances;
               (d) the training CLI with --sup_exec over 2 epochs at batch
               4 x 16000: after each, a knn probe on the card and one on
               the CPU (run_probe --device cpu), waited on, every return
               code 0; (e) ``python -m pase_tpu_torch.transfer_gate``
               (a process of its own, started after phase 13) cut to
               GATE_EPOCHS epochs of the JAX
               record's 250 steps:
               the random-init probe below 1 and the pretrained one above
               it, printed beside benchmarks/transfer_gate_r5.json (8
               epochs); (f) after it in the same process, ``python -m
               pase_tpu_torch.util_scripts forward-chunk --chunk_size
               1600000`` over a seeded 100 s file (one window, a long
               export bucket: K1 at [1,10000,512]), its (256, 10000)
               frames finite and within 1e-5 of the in-memory encoder's.
 20. recurrent — cuDNN's LSTM / GRU (float32, TF32 off): (a) PASE+ with
               rnn_type lstm and gru (a BiRNN of 256 each way) at
               (8,1,160000), card vs CPU within 2e-4 of max|y|, its
               forward ms; the 16000 bucket exported and served against
               the offline encoder (2e-5); the lstm encoder's workers+
               step card vs CPU at 2 x 16000 (phase 16's rule) and its
               rate at 32 x 32000; (b) workers+ with its prosody head a
               GRU head, one step card vs CPU (phase 16's rule); (c) the
               WaveRNN head at workers+wavernn.cfg's widths (rnn 512, fc
               512, 9 bits, aux 32, scales 4 x 4 x 10), RAW and MOL, at 2 x
               1600 in train mode: logits within 1e-4 of their largest,
               the loss within 1e-4, the gradients (the smoothing kernels
               too) under the CPU loss's cotangent by phase 7's rule;
               (d) recipes/run_pase_wavernn.sh's step at its own shape
               (16 x 32000, bf16, its flags through the CLI's parser) in
               this process: 3 steps after 1, against the same with
               workers+: steps/s, one profiled step's busy ms split into
               cuDNN RNN, GEMM, conv and the rest, the idle share, the
               peak memory, every loss finite; (e) the recipe's CLI
               (--synthetic) for one epoch with its chunk cut to 3360 (the
               epoch at 32000 would take minutes; 3360 is the least whole
               number of frames the *_long targets' deltas allow); (f)
               generate, RAW, at
               the head's widths, 2 x 1600 samples: us per sample, and the
               teacher-forced forward on its own samples against its
               loop's logits within 1e-4 of their largest.
 21. encoders — the alternative encoders (pase_tpu_torch/encoders.py):
               (a) TDNNFe at cfg/frontend/TDNN.cfg, seeded weights,
               float32, through phase 4's checks (the (1,1,100000)
               contract, (8,1,160000) forward ms, card vs CPU within 2e-4
               of max|y|); (d) its export (buckets 8000-64000: halo null,
               hop 160), serve-encode over phase 5's four wavs within 2e-5
               of forward-chunk --chunk_size 64000, the streaming export
               refused with the JAX stream's TypeError; (b) one TDNN.cfg
               / workers+ step at 2 x 16000 card vs CPU (phase 16's rule);
               (c) recipes/run_pase_tdnn.sh's flags through the CLI with
               --synthetic at 64 x 32000, bf16, one epoch, bench.py's
               distortion stack in place of the recipe's pase+.cfg (whose
               corpora are not in the repository): steps/s beside phase
               8's bf16 rate, one profiled step's kernel time by kind and
               idle share, peak memory; (e) ASPPResEncoder (without and
               with its QRNN) and ResnetEncoder at the JAX modules'
               defaults at (8,1,32000), card vs CPU within 2e-4, T / hop
               frames (the ResNet's hop 40); a narrow ASPP (with its
               QRNN) / workers+ step card vs CPU, dropout off on both
               sides. Phase 3 holds K1 at the TDNN serving shape
               [8,1000,256] and K1's eval kernel and K2 at the recipe's
               [192,200,256].
 22. options — the step's options: (a) recipes/run_pase_attention.sh's
               flags (PASE+, workers+, cfg/attention.cfg: K 64,
               avg_factor 0.3, avg_time, hidden [128]; 16 x 32000, bf16,
               poly lr, --random_scale True) through the CLI with
               --synthetic for one epoch, bench.py's distortion stack in
               place of the recipe's pase+.cfg: steps/s beside phase 8's
               bf16 rate, every loss finite, each running_dist summing to
               1 within 1e-5 and each mask with exactly 64 ones, peak
               memory, one profiled step's busy split and idle share;
               (b) one attention step and one --chunking_K 64 step at
               PASE+ / workers+ 2 x 16000, card vs CPU (phase 16's rule,
               the masks equal); (c) one step of each of the eight
               policies at 2 x 16000, card vs CPU (phase 16's rule), the
               policy's weights and next alpha within 1e-5 of their
               largest (MGD 1e-4), select_half's and dropout's masks
               injected; then --backprop_mode MGD through the CLI at 32 x
               32000 bf16 for CLI_STEPS steps against the base policy's, the
               MGD step's pase.mgda device time, and softmax's step (its
               losses in float32) against base's; (d) one step of RAdam,
               AdamW, SGD and RMSprop card vs CPU, the parameters after
               it within 1e-5 of their group's largest where the CPU's
               gradient is above 1e-4 of its leaf's largest (else within
               2 lr max|u|), and phase 11's child resumes an RMSprop run;
               (e) workers+ plus a regu_cchunk regularizer (MSELoss, the
               clean chunk a fourth stream), an lpc worker and one head
               with dropin 0.2 fixed_rand, tie_context_weights and a
               context-3 dropout_time 0.1 (its masks the card's on the
               CPU), one step card vs CPU at 2 x 16000. Phase 3 holds K1's
               loop and K2 at [64,200,512] (the recipe's batch with the
               regularizer's fourth stream) as well.
 23. ami     — AMI pretraining and the step-level tools: (a) a seeded AMI
               meeting tree (4 meetings of 165 s, 4 headsets, 8 Array1
               channels each a delayed, attenuated mix of the headsets plus
               noise) through the port's data_prep ami-segment and ami-cfg
               (--map_ihm2sdm 1,3,5,7; about 0.7 h of headset segments), then
               recipes/run_pase_libri_ami.sh's flags through the CLI for one
               epoch (PASE+, workers.cfg, 32 x 32000, bf16; a seeded 900 s
               LibriSpeech-layout corpus with bench.py's stack for its
               pase+.cfg, the AMI part in tree mode with --dtrans_cfg None
               and the headset segments as --clean_root): steps/s against
               the same flags with --synthetic in this process, the feed
               wait and staging per step, the share of rows whose
               distortion mask was off against the AMI share of the corpus
               (within 5 binomial sd); then a shorter epoch (every 4th
               train utterance) in channel-key mode (--ihm2sdm 1,3,5,7) and
               one of the AMI part alone in tree mode from --device_corpus;
               (b) util_scripts profile-step at PASE+ / workers+ 32 x 32000
               in bf16 and float32 beside phase 8's rates, eval-ckpts over
               (a)'s three FE_e0.npz, precompute-feats over the cut
               LibriSpeech part and a --cache_feats_dir epoch; (c)
               export-torch of (a)'s artifact loaded back
               (load_frontend_ckpt): the forward on the card bit for bit;
               a reference-keyed PASE+ / workers+ state dict
               (load_reference_pase_ckpt) into another seed's model: one
               step's losses bit for bit; (d) log_histograms /
               log_grad_norms rows of one PASE+ / workers+ step at 2 x
               16000 card vs CPU (the same CPU-computed targets: lo / hi
               within 1e-4 of the row's largest, counts moved only by
               values within 1e-4 (hi - lo) of an edge, grad norms within
               1e-3 relative), and the bf16 step at 32 x 32000 with
               fused_heads=False against the fused default in turns
               (STEP_RATE_ROUNDS rounds of 4 steps after a warm one).
 24. kaldi   — the Kaldi worker targets and the other tools: (a)
               workers+.cfg plus kaldimfcc (39 outputs, num_ceps 13,
               der_order 2) and kaldiplp (20, num_ceps 20, der_order 0)
               heads shaped like its mfcc head, their ZNorm statistics from
               make_trainset_statistics --synthetic, one epoch of the
               training CLI with PASE+ at 32 x 32000, bf16, bench.py's
               stack as --dtrans_cfg; the Kaldi targets of one clean batch
               card vs CPU (within 1e-4 of each target's largest); the step
               against phase 8's bench step in this process in turns
               (STEP_RATE_ROUNDS rounds of 4 steps after a warm one), each profiled:
               pase.prepare device ms and device activities a step; (b) on
               a seeded corpus of 200 utterances of 2 s, util_scripts
               clusterize (k 128, (a)'s encoder; the CPU's KMeans of the
               same features from the same initial rows, the frames
               assigned otherwise counted; the Lloyd steps replayed side
               by side on card and CPU, every frame assigned otherwise a
               rounding tie, the card's replay clusterize's output),
               project-features
               (2 components), prosodic-eval ((a)'s weights_PASE-*.npz and
               statistics), make-fbanks, vadproc, make-contaminated (the
               bench stack) and select-ckpt, each's seconds, audio-s/s and
               K1 launches; (c) data_prep segment, iemocap-segment with
               probe-lists --holdout and chime5-cfg on seeded trees, their
               files checked.
 25. parallel — multi-GPU (pase_tpu_torch/parallel): (a) the data-parallel
               step: two processes of this script (--dp-step), gloo ranks
               both on cuda:0, each 16 of phase 7's seeded 32 x 32000 rows
               (float32, TF32 off, random_scale: the gains drawn for the
               global batch), two steps, against the one-process step on
               the whole batch on the card: per-worker losses within 1e-4
               relative (step 2: 1e-3), the ranks' losses bit for bit
               equal, rank 0's all-reduced step-1 gradient within 1e-3 of
               each group's largest with the one process's PReLUs on the
               ranks' side of the kink (phase 7's rule; the flips within
               1e-5 of their module's largest), the step ms of each; (b)
               the training CLI with --coordinator_address --num_processes
               1 --process_id 0 (NCCL) at 32 x 32000 bf16 for CLI_STEPS
               steps: FE_e0.npz, every loss finite; (c) the training CLI
               with --device_corpus --shard_device_corpus in two gloo
               processes (--cli-rank) on a seeded corpus of at least 8
               prefix groups (SHARD_CORPUS_S): each rank's bytes on the
               card, summing to the corpus's, the ranks' metrics rows bit
               for bit equal; (d) encode_time_sharded over [cuda:0] x 4 at
               (2, 960000) against the offline forward (atol = rtol =
               2e-5), the gradient of a fixed linear loss at (1, 64000)
               against offline (atol 1e-5, rtol 1e-4), forward-chunk
               --time_shard over a 10 s file against the offline forward,
               and the forward ms of both. A rank that exits non-zero or
               outlives DP_TIMEOUT fails the phase.
 26. host-stage — the host distortion stage, the decoders, and the
               repairs of the attention variant's ranks and the dropout
               masks: (a) ``python -m pase_tpu_torch.train`` on phase 12's
               corpus (PASE+, workers+, 32 x 32000, bf16, --num_workers 4)
               with bench.py's stack plus codec2_p 0.2 (codec2_kbps 1600:
               the vendored vocoder, pase_tpu_torch/csrc/codec2_lite.cc,
               built by g++) and whisper_p 0.1 (identity: ahocoder is
               absent), against the same command without the two keys, in
               turns (STEP_RATE_ROUNDS rounds): steps/s, feed wait, the
               stage's ms a batch and the share of rows through codec2
               (within 5 binomial sd of 0.2), every loss finite; (b)
               ``util_scripts encode-codec2`` over 100 seeded 2 s wavs: s,
               audio-s/s, each output bit for bit the in-process
               Codec2RoundTrip's; (c) SpectrogramDecoder at [8,1000,256] ->
               [8,1000,513] and SpectrumLM (2 x LSTM 512, out 513, B=8,
               100 closed-loop steps, a forced frame) card vs CPU within
               1e-4 of max|y|, with ms; (d) phase 25 (a)'s two gloo ranks
               at the attention recipe's width (cfg/attention.cfg, 16 x
               32000; the blocks' batch means over the global batch)
               against one process, by its rule, the running_dist buffers
               within 1e-6; (e) dropout masks from a CUDA generator at
               [96,200,512]: one seed bit for bit, the keep share within 5
               sd of 0.75, two ranks' rows of the one global draw bit for
               bit.
 27. n-model — column-parallel compute (--n_model, parallel/tp.py), held
               to one one-process run of the step (phase 25's first batch
               in float32, then bf16 steps: its rate): (a) that step on a
               1 x 2 grid (two gloo ranks on the card holding the
               parameters' column shards; the QRNN split by lanes, K2 at
               [96,200,256] on each) against it by phase 25's rule for
               step 1 (the PReLU masks assembled by rows and channels);
               (b) the same
               on a 2 x 2 grid (four ranks, 16 rows each: K2 at
               [48,200,256]), then each rank's steady bf16 steps/s
               (TP_RATE_STEPS after one warm-up); (c) ``python -m
               pase_tpu_torch.train --n_model 2`` in two gloo processes
               (--cli-rank) at 32 x 32000 bf16 for TP_CLI_STEPS steps
               (K1's eval kernel at [96,200,256] in its eval; each step
               logged:
               the 1 x 2 grid's steady bf16 steps/s from its rows), its
               checkpoint resumed in one process (strict) and its
               FE_e0.npz that process's encoder bit for bit; (d) the
               parameter and Adam bytes per rank of (a) and (b) against
               one process's: the sharded leaves' 1 / n_model plus the
               whole replicated ones.
 28. rehearsal — ``bash pase_tpu_torch/recipes/rehearsal.sh`` whole
               (REHEARSAL_ENV: HOURS 0.25, EPOCHS 3, 32 x 32000 float32,
               PASE+ / workers+), every assertion of the script: the
               corpus and its statistics, run A, run B with --sup_exec
               probes killed (-9) in epoch 2 and resumed in a new process,
               A's and B's FE_e2.npz bit for bit (or, where two
               uninterrupted card runs differ, B within twice their
               spread), the export, serve-encode within 2e-4 of
               forward-chunk, the probe fired and beating chance and the
               random-init encoder. It starts with the gate after phase
               13. Each
               ``python -m`` CLI of the script runs through this script's
               --counted mode (a ``python`` first on its PATH), which
               writes the CLI's launch counts and TF32 flags at each launch
               and at exit: every --device CLI has both TF32 flags off
               after its setup; run A launches the training kernels once
               per layer per train step and qrnn_pool_fwd once per layer
               per eval step, run B (killed and resumed) at least as many,
               forward-chunk and serve-encode K1's unseeded route (the
               few-lane kernel at the rehearsal's [1,800,512]) once per
               layer and nothing else. Beside run B, one epoch of run
               A's command under torch's deterministic algorithms (a
               process of its own) lists the ops torch has no
               deterministic implementation of. Prints the script's PASS
               lines, each step's seconds and the launches of each CLI.
 29. trained gates — once every phase above has ended: run A's last
               FE_e*.npz (phase 28), the first QRNN layer's pooling input
               on a 2 s and a 100 s seeded wav; the few-lane kernel and
               the split kernel on it in turns (CUDA graphs), each within
               1e-5 of the plain
               version; the split kernel's share of segments run again
               and the quantiles of a = 1 - f.
Main paths, each with the launch counts reset to 0 just before it and
read just after: serving (phases 4-5) must launch the kernel of K1's
unseeded route (cuda_qrnn.forward_entry: qrnn_pool_fwd_few, its wide
tile at the (8,1,160000) batch's [8,1000,512], its narrow one at B = 1)
once per QRNN layer per encoder call and qrnn_pool_fwd never; training
(the CLI in phase 7) must launch qrnn_pool_fwd_train and qrnn_pool_bwd
once per QRNN layer per train step, and qrnn_pool_fwd once per layer per
eval step (batch 3 x 32: above the few-lane route's lane count); the
distorted step (phase 8, bf16 and float32 each) the training kernels once
per layer per step;
each disk-fed run (phase 12, five of them) the training kernels once per
layer per train step and qrnn_pool_fwd once per layer per eval step;
the bf16 conv_proto run (phase 9) conv_s1_tc once per layer, 7 in all,
the float32 run conv_s1_tf32x3 7 times; each stream (phase 13)
qrnn_pool_fwd_seg once per QRNN layer per push that reaches the QRNN and
no other forward kernel; serve-encode through the exported programs
(phase 14) the unseeded route (the few-lane kernel) once per layer per
program call, and the B=40 call the eval kernel; the overlap step (phase
15) the
training kernels once per layer; phase 16's steps (VQ, v0.1, Gap) the training
kernels once per QRNN layer (none in v0.1, which has no QRNN), the VQ
training CLI the training kernels once per layer per train step and
qrnn_pool_fwd once per layer per eval step, the v0.1 CLI none; phase 17's
VQ serving path the unseeded route once per layer per encoder call (the
few-lane kernel at B = 8 and at B = 1),
its streams qrnn_pool_fwd_seg once per layer per push that reaches the
QRNN, its serve-encode the few-lane kernel once per layer per program
call;
phase 18's GAN steps (wave, z) the training kernels once per layer (D
has no QRNN), each recipe CLI run the training kernels once per layer
per train step and qrnn_pool_fwd once per layer per eval step, the snorm
and wnorm encoders the unseeded route once per layer per call;
phase 19's probe runs (utt, knn, kfold, frames, timit-full) the
unseeded route at B = 1 (the few-lane kernel) once per layer per
utterance encoded and nothing else, forward-chunk over a 100 s file in
one window (in the gate's process) the split kernel once per layer and
nothing else, the superviser's training run the training kernels once per layer
per train step and the unseeded route once per layer per eval step (3 x
4 rows: the eval kernel), the transfer gate (its encoder has no QRNN)
none; phase 20's
lstm and gru encoders (serving) and the lstm encoder's step none (no
QRNN), the GRU-head step and the WaveRNN recipe's steps the training
kernels once per layer per step, its CLI the training kernels once per
layer per train step and qrnn_pool_fwd once per layer per eval step,
generate none; phase 21's TDNN serving path and its serve-encode
the unseeded route (the few-lane kernel at [8,1000,256] and at B = 1)
once per encoder / program call and
nothing else,
the TDNN and narrow ASPP steps the training kernels once each, the TDNN
recipe's CLI the training kernels once per train step and qrnn_pool_fwd
once per eval step (192 x 256 lanes), ASPP with its QRNN the few-lane
kernel once per call, ASPP without it and the ResNet
none; phase 23's
CLI epochs (the AMI recipe, its --synthetic twin, channel-key, device
corpus, the feature cache) the training kernels once per train step and
qrnn_pool_fwd once per eval step, profile-step the training kernels once
per step (3 warm-up and 20 timed, each dtype), eval-ckpts qrnn_pool_fwd
once per eval batch; phase 24's CLI epoch the training kernels once per
train step and qrnn_pool_fwd once per eval step, its profiled steps the
training kernels once each, clusterize, project-features and
prosodic-eval the unseeded route at B = 1 (the few-lane kernel) once per
utterance, the other tools
none; phase 25's data-parallel step (both ranks) the training kernels
once per layer per rank per step, dp_cli as phase 7's CLI, the sharded
corpus (both ranks) the training kernels once per layer per rank per
train step and qrnn_pool_fwd once per layer per rank per eval step (48
rows x 512 lanes), the time shard the few-lane kernel on D - 1 shards
(pass 1) and qrnn_pool_fwd_seg on D (pass 2) per layer, its gradient
qrnn_pool_fwd_train and qrnn_pool_bwd 2 D - 1 times per layer, and
forward-chunk --time_shard (D = the visible cards) as the time shard;
phase 26's CLI epochs with and without the host stage the training
kernels once per layer per train step and qrnn_pool_fwd once per layer
per eval step, encode-codec2 and the decoders none, the attention
variant's ranks the training kernels once per layer per rank per step;
phase 27's grid steps (every rank) the training kernels once per layer
per rank per step, its CLI once per layer per rank per train step and
qrnn_pool_fwd once per layer per rank per eval step; phase 28's runs A and
B (summed over B's two processes) as phase 7's CLI, forward-chunk and
serve-encode the few-lane kernel once per layer, the probes once per
layer per utterance.
The kernels line gives each kernel's launches on every path ("paths":
serving, training, stream (phase 13's four streams), stream_cli
(forward-chunk --streaming), export (phase 14's serve-encode), phase
16-17's vq_step, vq_training, v01_step, v01_training, gap_step,
vq_serving, vq_stream, vq_export, phase 18's gan_step, gan_z_step,
gan_cli, gan_cli_plain, snorm_serving, wnorm_serving, and phase 19's
probe (the utt run), probe_knn, probe_kfold, probe_frames, probe_timit,
probe_sup, transfer_gate, forward_chunk_100s, phase 20's lstm_serving,
gru_serving,
lstm_step, gru_head_step, wavernn_step, wavernn_cli, wavernn_generate,
and phase 21's tdnn_serving, tdnn_export, tdnn_step, tdnn_cli,
aspp_serving, aspp_rnn_serving, resnet_serving, aspp_step, and phase
22's attention_cli, attention_step, chunking_step, policy_<mode>_step
for the eight modes, mgd_cli, base_cli, opt_<rule>_step, regu_step, and
phase 23's ami_cli, ami_channel_key, ami_device_corpus, profile_step,
eval_ckpts, cache_feats, and phase 24's kaldi_cli, kaldi_step,
clusterize, project_features, prosodic_eval, and phase 25's dp_step,
dp_cli, sharded_corpus, time_shard, time_shard_grad, time_shard_cli, and
phase 26's host_stage_cli, host_stage_plain, encode_codec2, decoders,
dp_attention, and phase 27's tp_step_1x2, tp_step_2x2, tp_cli, and
phase 28's rehearsal (every CLI process of the script, summed):
the steps the training kernels once per layer (MGD's per-worker
gradients reuse the loss forward's graph: no second forward), the CLI
runs once per layer per train step and qrnn_pool_fwd once per layer per
eval step); the QRNN kernels' entries also give their time, plain time
and bound at phase 21's TDNN shape ("tdnn"), and the loop and K2 at the
attention recipe's [48,200,512] ("attention") and at [64,200,512]
("regu"), and at the data-parallel step's per-rank [48,200,512] ("dp"),
K2 at the attention variant's per-rank [24,200,512] ("dp_attention"),
and the loop and K2 at phase 27's lane shards [96,200,256] ("tp") and
[48,200,256] ("tp_2x2"); the few-lane kernel's entry its time at
[1,200,512], at the serving batch ("serving"), at phase 21's TDNN shape
("tdnn"), at each of FEW_SHAPES ("shapes": beside the streaming floor,
the empty kernel and the byte bound, on random, slow and frozen gates)
and on phase 29's trained gates ("trained").
No other path launches a conv kernel.
Schedule: phases 1-9 and 13, which time every kernel, run alone in this
process. Then the gate (19 e), phase 11, the rehearsal (28) and a lane
process with phases 22-25 and 27 (``--lane``) start, each in a session of
its own, and this process runs phases 10, 12, 14-21 and 26 beside them;
it prints the lane's lines between its phases and joins them all at the
end; phase 29 runs last, alone. Their rates and seconds are taken on a
shared host and card. CPU
ops run on SHARED_THREADS threads here and in the lane, CHILD_THREADS in
the others. The line before the last is a
JSON summary of the kernels; the last line is {"ok": true, "device":
{...}}.
"""

import concurrent.futures
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PASEP_CFG = os.path.join(HERE, "cfg", "frontend", "PASE+.cfg")
WORKERSP_CFG = os.path.join(HERE, "cfg", "workers", "workers+.cfg")
# phases 16-17: the residual VQ-8192 encoder and the PASE v0.1 bank
VQ_CFG = os.path.join(HERE, "cfg", "frontend", "PASE+_resblocks_VQ8192.cfg")
V01_CFG = os.path.join(HERE, "cfg", "frontend", "PASE.cfg")
V01_WORKERS = os.path.join(HERE, "cfg", "workers", "workers.cfg")
KERNEL_ATOL = 1e-5
# qrnn_pool_fwd_eval against the chunked plain version of its algebra (the
# same operations in the same order; tanh / exp round otherwise on the
# card)
EVAL_ALG_ATOL = 5e-7
# the steps of every --synthetic training CLI epoch in this run (the CLI's
# own default is 100; the eval takes a tenth, at least one batch)
CLI_STEPS = 10
ENCODER_REL = 2e-4
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-3
# a PReLU input on opposite sides of 0 on card and CPU must lie this close
# to 0, relative to its module's largest input (float32 rounding)
FLIP_REL = 1e-5
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per lane-step, tanh / exp / divide counted as one each
FWD_OPS, BWD_OPS = 14, 25
# (B, T, H) of the train step's QRNN at batch 32, 8 and 16 (3 streams x B
# chunks of 32000 samples -> 200 frames, rnn_dim 512; 16: the WaveRNN
# recipe's step), at batch 16 x 3360 samples (21 frames, phase 20's cut
# CLI, which also runs K1's eval kernel there in eval), and the TDNN
# recipe's 64 x 32000 (emb_dim 256; phase 21, which also runs K1's eval
# kernel there in eval), and phase 27's lane shards (TP_SHAPES)
TRAIN_QRNN_SHAPES = [(96, 200, 512), (24, 200, 512), (48, 200, 512),
                     (48, 21, 512), (192, 200, 256), (64, 200, 512),
                     (96, 200, 256), (48, 200, 256)]
TRAIN_SHAPE = (96, 200, 512)
TRAIN_BATCH, TRAIN_CHUNK = 32, 32000
# phase 27: the grids {name: (processes, n_model)} of PASE+ / workers+ at
# TRAIN_BATCH x TRAIN_CHUNK, their per-rank K2 / K1 shapes (3 streams x
# the data index's rows, rnn_dim 512 / n_model lanes), the bf16 steps a
# rank times after one warm-up, the CLI's n_model and its epoch's steps
# (every column layer's channels cross the gloo loopback between the ranks
# sharing the card: a step takes seconds)
TP_GRIDS = {"1x2": (2, 2), "2x2": (4, 2)}
TP_SHAPES = {"1x2": (96, 200, 256), "2x2": (48, 200, 256)}
TP_RATE_STEPS = 1
TP_CLI_MODEL, TP_CLI_STEPS = 2, 2
# phase 25: two ranks share the card (gloo); a rank that runs longer fails
DP_RANKS = 2
DP_TIMEOUT = 300
# the data-parallel step's second step against one process: Adam's first
# update is near sign(g), so rounding-level gradient differences move a
# weight by up to 2 lr (tests/test_torch_train.py's three-step bound)
DP_STEP2_REL = 1e-3
# phase 26: the host stage's keys added to bench.py's stack on phase 12's
# corpus (whisperize is identity without ahocoder); encode-codec2's seeded
# 2 s wavs; the decoders' shapes (SpectrogramDecoder at its defaults:
# nfft 1024, three 256-map stride-1 stages; SpectrumLM 2 x LSTM 512, out
# 513); the card-vs-CPU bound of both; the attention recipe's batch on two
# ranks (d), its running_dist against one process; the masks' p and shape
# (e: the QRNN's [3 x 32, 200, 512] hidden)
CODEC2_P, CODEC2_KBPS, WHISPER_P = 0.2, 1600, 0.1
CODEC2_WAVS = 100
SPEC_DEC_SHAPE = (8, 1000, 256)
LM_BATCH, LM_STEPS, LM_RNN, LM_LAYERS, LM_OUT = 8, 100, 512, 2, 513
DEC_REL = 1e-4
ATT_BATCH = 16
DP_RUNNING_ATOL = 1e-6
MASK_P, MASK_SHAPE = 0.25, (96, 200, 512)
# the sharded corpus's train and valid seconds (at least 8 prefix groups)
SHARD_CORPUS_S = (360.0, 80.0)
# the time shard: D shards on cuda:0, the forward at 60 s, the gradient at
# 4 s; tests/test_sequence_parallel.py's bounds
TS_SHARDS = 4
TS_SHAPE = (2, 960000)
TS_GRAD_SHAPE = (1, 64000)
TS_TOL = 2e-5
TS_GRAD_ATOL, TS_GRAD_RTOL = 1e-5, 1e-4
# (B, T, H) of the QRNN pooling: the four shapes of benchmarks/bench_qrnn.py,
# the serving batch (8 x 10 s windows at 100 frames/s), one window alone
# (forward-chunk's file at a time), 32 and 48 x 200 (the unseeded route
# took the loop from 16384 lanes before the eval kernel), 48 x 21, the
# eval of phase 20's cut WaveRNN CLI, and phase 21's TDNN shapes at H =
# 256: the serving batch and the recipe's eval, and phase 22's 4 x 16 rows
# (the attention recipe's batch with a regularizer's fourth stream), and
# phase 27's lane shards, and B = 1 extraction of a 2 s utterance, the
# rehearsal's 8 s file and the time shard's [2,1500,512]
QRNN_SHAPES = [(96, 200, 512), (24, 200, 512), (1, 10000, 512),
               (8, 4000, 512), (8, 1000, 512), (1, 1000, 512),
               (32, 200, 512), (48, 200, 512), (48, 21, 512),
               (8, 1000, 256), (192, 200, 256), (64, 200, 512),
               (96, 200, 256), (48, 200, 256), (1, 200, 512),
               (1, 800, 512), (2, 1500, 512)]
# the split kernel's target shape (a 100 s file in one forward)
LONG_SHAPE = (1, 10000, 512)
# the few-lane kernel's shapes timed beside both floors: B = 1 extraction
# of a 2 s utterance (the probes' 3120 launches), the rehearsal's 8 s file,
# forward-chunk's 10 s window, the time shard's [2,1500,512], the serving
# batch; also on gates whose carries decay slowly or never
FEW_SHAPES = [(1, 200, 512), (1, 800, 512), (1, 1000, 512), (2, 1500, 512),
              (8, 1000, 512)]
FEW_GATE_SHAPES = [(s, kind) for s in FEW_SHAPES
                   for kind in ("slow", "frozen")]
# a trained encoder's gates (phase 28's run A): seconds of the seeded wavs
TRAINED_GATE_SECONDS = (2, 100)
# the split kernel on gates whose carries decay slowly (f less 6) and not
# at all (f = 0 from the second step; a ragged last segment), where its
# second run takes every segment of a tile
QRNN_GATE_SHAPES = [((1, 10000, 512), "slow"), ((1, 9999, 512), "frozen")]
# phase 19: a 100 s file through forward-chunk in one window (--chunk_size
# the file's samples: a long export bucket), in the gate's process
FC_LONG_SAMPLES = 1600000
SERVING_SHAPE = (8, 1000, 512)
WAV_SECONDS = [3.0, 7.3, 10.0, 12.5]
SR = 16000
# phase 8: the card-vs-CPU distortion bound
DIST_REL = 1e-5
TRAJECTORY = os.path.join(HERE, "tests", "fixtures",
                          "torch_port_trajectory.json")
# phase 9: kernel vs plain, relative to max|y_plain|: one bf16 rounding of
# float32 sums taken in another order; float32 sums in another order
CONV_REL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
CONV_L3 = 2                 # L3: (1600, 11, 1, 128, 128)
# phase 12: the corpus (seconds of train and valid audio: 28 steps and one
# eval batch an epoch) and the feeds
DISK_TRAIN_S, DISK_VALID_S = 900, 120
DISK_FEEDS = (("host ChunkBatcher", ["--num_workers", "1"]),
              ("4 host threads", ["--num_workers", "4"]),
              ("4 host threads int16 wire", ["--num_workers", "4",
                                             "--wire_dtype", "int16"]),
              ("device corpus", ["--device_corpus"]))


# phases 13-14: the streaming contract (tests/test_streaming.py), the
# serving contract (tests/test_serving.py), the pushes and the chunk
STREAM_RTOL, STREAM_ATOL = 1e-3, 2e-4
SERVE_TOL = 2e-5
STREAM_SECONDS = 10
STREAM_PUSHES = (("1 s", 16000), ("100 ms", 1600))
EXPORT_BUCKETS = "8000,16000,32000,64000"
# the VQ8192 artifact's buckets (phase 17; a window takes the smallest
# bucket that holds it and its halo, exact at any set)
VQ_EXPORT_BUCKETS = "32000,64000"
EXPORT_CHUNK = 16000
# a batch above the few-lane route's lanes (40 x 512 >= 16384)
EXPORT_WIDE_BATCH = 40
# phase 4's operator timing: calls per host-time sample (5 samples), and
# alternating pairs of forwards per batch of 160000 samples
OP_CALLS = 300
OP_PAIRS = {1: 200, 8: 40}
# phase 13's latency floor: cycles of one dependent float32 FMA on the SM
# (published microbenchmarks of Volta to Hopper)
FMA_LATENCY_CYCLES = 4
# phase 13's K1 shapes (B, T): 1 s and 100 ms pushes at B=1 and 8
PUSH_SHAPES = [(1, 100), (8, 100), (1, 10), (8, 10)]
# phase 18: the GAN recipe, its z variant, the card-vs-CPU bounds of D
# (parameters after a step relative to their largest, where D's gradient
# is above D_LIVE_REL of its leaf's largest; u absolute)
GAN_RECIPE = "recipes/run_pase_plus_gan.sh"
GAN_Z_CFG = {"type": "z", "loss": "BCE", "lr": 0.0004, "weight": 1.0,
             "cchunk_prior": True}
GAN_D_REL = 1e-4
D_LIVE_REL = 1e-4
GAN_U_ATOL = 1e-5
# the recipe's flags that name the corpus, its statistics and its
# distortion assets (not in the repository; the phase trains --synthetic)
RECIPE_DATA_FLAGS = ("--data_root", "--data_cfg", "--stats", "--dtrans_cfg",
                     "--save_path")
# phase 19: the MiniVoxCeleb probe recipe (its flags), the utterances
# extracted on card and CPU, the TIMIT-shaped corpus (utterances, seconds),
# the superviser's probe lists (the first speakers) and its training batch
PROBE_RECIPE = "recipes/probes/run_spkid_minivox.sh"
PROBE_CHECK_UTTS = 16
TIMIT_TRAIN, TIMIT_TEST, TIMIT_SECONDS = 24, 12, 2.0
SUP_SPEAKERS = 4
SUP_BATCH = 4
# the transfer gate's pretraining: epochs of the JAX record's 250 steps
# (the record has 8; at 4 the final margin has read +0.046 and +0.067
# about its 0.05, so `ok` may read either way; after 3 the curve has read
# 0.929 to 0.958 against the random-init probe's 0.921; the script checks
# the pretrained probe above the random-init one)
GATE_EPOCHS, GATE_BPE = 4, 250
# phase 20: the WaveRNN recipe and its worker cfg, the head at the cfg's
# widths, the card-vs-CPU check's batch and samples and its logit bound,
# the CLI epoch's cut chunk (whole 160-sample frames, and at least the
# 3328 samples the *_long targets' deltas need), generate's batch and
# frames, and the encoder train step's batch
WAVERNN_RECIPE = "recipes/run_pase_wavernn.sh"
WAVERNN_CFG = os.path.join(HERE, "cfg", "workers", "workers+wavernn.cfg")
WAVERNN_HEAD = dict(num_inputs=256, rnn_dims=512, fc_dims=512, bits=9,
                    pad=2, upsample_scales=(4, 4, 10), res_out_dims=128)
WAVERNN_CHECK = (2, 1600)
WAVERNN_LOGIT_REL = 1e-4
WAVERNN_CLI_CHUNK = 3360
GENERATE_SHAPE = (2, 10)
RNN_STEP_SHAPE = (32, 32000)
# phase 21: the alternative encoders (pase_tpu_torch/encoders.py): the TDNN
# recipe and its cfg, the K1 / K2 shapes its path sends (the serving batch
# at H = 256, and the recipe's 3 x 64 rows of 200 frames), ASPP and the
# ResNet at the JAX modules' defaults (ASPP also with its QRNN) and their
# forward batch, and a narrow ASPP (with its QRNN) for the card-vs-CPU step
TDNN_RECIPE = "recipes/run_pase_tdnn.sh"
TDNN_CFG = os.path.join(HERE, "cfg", "frontend", "TDNN.cfg")
TDNN_SERVING_SHAPE = (8, 1000, 256)
TDNN_TRAIN_SHAPE = (192, 200, 256)
ALT_ENCODERS = {"aspp": {"name": "asppRes"},
                "aspp_rnn": {"name": "asppRes", "rnn_pool": True},
                "resnet": {"name": "Resnet50"}}
ALT_SHAPE = (8, 32000)
ASPP_STEP_CFG = {"name": "asppRes", "sinc_out": 16, "hidden_dim": 64,
                 "fmaps": [16, 16, 16, 16],
                 "concat": [False, False, True, True], "rnn_pool": True}


# phase 22: the attention recipe, its cfg and K; the attention recipe's K2
# shape (3 x 16 rows) and with a regularizer's fourth stream; the
# policies, the card-vs-CPU bounds of their weights and next alpha
# (relative to the largest), the CLI's MGD / base steps; the optimizers
# and the bound on their parameters after a step (relative to the
# group's largest, where the gradient is live); the heads' options; the
# rounds of the steady-state step rates (policies and optimizers beside
# the base step, in turns)
ATT_RECIPE = "recipes/run_pase_attention.sh"
ATT_CFG = os.path.join(HERE, "cfg", "attention.cfg")
ATT_K = 64
ATT_DIST_REL = 1e-5
ATT_TRAIN_SHAPE = (48, 200, 512)
REGU_TRAIN_SHAPE = (64, 200, 512)
POLICIES = ("base", "select_one", "select_half", "dropout", "hyper_volume",
            "softmax", "adaptive", "MGD")
POLICY_REL, MGD_REL = 1e-5, 1e-4
OPTIMIZERS = ("RAdam", "AdamW", "SGD", "RMSprop")
OPT_PARAM_REL = 1e-5
OPT_LIVE_REL = 1e-4
HEAD_OPTIONS = {"dropin": 0.2, "dropin_mode": "fixed_rand",
                "ratio_fixed": 0.5, "tie_context_weights": True,
                "context": 3, "dropout_time": 0.1}
STEP_RATE_ROUNDS = 1
# phase 23: the AMI recipe; the seeded meeting tree (about half an hour
# of headset segments), its distant channels and the LibriSpeech part's
# seconds; the shorter epochs keep every AMI_CUT-th utterance; the
# eval-ckpts batches; the card-vs-CPU bounds of the trainer's rows
# (histogram lo / hi relative to the row's largest, its counts allowed to
# move only for values within HIST_EDGE_REL (hi - lo) of an edge; grad
# norms relative)
AMI_RECIPE = "recipes/run_pase_libri_ami.sh"
AMI_MEETINGS, AMI_MEETING_S = 4, 165.0
AMI_CHANS = "1,3,5,7"
AMI_LIBRI_S = 900
AMI_CUT = 4
EVAL_CKPT_BATCHES = 5
HIST_REL, HIST_EDGE_REL, GRAD_NORM_REL = 1e-4, 1e-4, 1e-3
# the repeated flags that name one corpus of a concatenation
CORPUS_FLAGS = ("--data_root", "--data_cfg", "--dtrans_cfg", "--dataset")
# phase 24: the Kaldi MFCC / PLP heads added to workers+ (each shaped like
# its mfcc head; der_order explicit), their targets' card-vs-CPU bound
# (each target's largest value); the tools' seeded corpus (utterances of
# TOOL_SECONDS), clusterize's k and Lloyd steps, and the rounding tie of
# a Lloyd step replayed on card and CPU from shared centres: a frame's
# two chosen centres within KMEANS_TIE_REL (|x|^2 + |c|^2) of each other
# in float64 (float32 expansion and means sum in other orders)
KALDI_HEADS = (("kaldimfcc", 39, {"num_ceps": 13, "der_order": 2}),
               ("kaldiplp", 20, {"num_ceps": 20, "der_order": 0}))
KALDI_REL = 1e-4
TOOL_UTTS, TOOL_SECONDS = 200, 2.0
TOOL_K = 128
KMEANS_ITERS = 50
KMEANS_TIE_REL = 1e-5


# phase 28: the rehearsal script, its depth (the script's defaults are
# HOURS=2 EPOCHS=5) and its time limit
REHEARSAL = os.path.join("pase_tpu_torch", "recipes", "rehearsal.sh")
REHEARSAL_ENV = {"HOURS": "0.25", "EPOCHS": "3"}
REHEARSAL_TIMEOUT = 900
# the host's cores once phase 13 is done: the main process and the lane of
# phases 22-25 and 27 run their CPU ops on SHARED_THREADS / LANE_THREADS
# threads each, the gate, phase 11 and the rehearsal's CLIs on
# CHILD_THREADS (torch's default, one a core, oversubscribes the host)
SHARED_THREADS = LANE_THREADS = 4
CHILD_THREADS = 2
LANE_TIMEOUT = 900
# the rehearsal's CLIs that take --device: TF32 off after their setup
DEVICE_CLIS = ("pase_tpu_torch.train", "pase_tpu_torch.util_scripts",
               "pase_tpu_torch.run_probe",
               "pase_tpu_torch.make_trainset_statistics")


class SmokeFailure(Exception):
    pass


def recipe_argv(script, env=None):
    """The training flags of a recipe script: the arguments after its
    ``python train.py`` (or after the recipe it ``exec``s, whose flags
    come first), ``${VAR:-default}`` taken from ``env`` ({VAR: value}) or
    at its default, "$@" dropped."""
    import re
    import shlex
    env = env or {}
    with open(os.path.join(HERE, script)) as f:
        text = f.read().replace("\\\n", " ")
    text = re.sub(r"\$\{(\w+):-([^}]*)\}",
                  lambda m: env.get(m.group(1), m.group(2)), text)
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:2] == ["python", "train.py"]:
            return [w for w in words[2:] if w != "$@"]
        if words[:1] == ["exec"] and words[1].endswith(".sh"):
            return recipe_argv(words[1], env) + [w for w in words[2:]
                                                 if w != "$@"]
    raise ValueError(f"{script}: no training command")


def qrnn_layers(module):
    """The QRNN layers of an encoder module (0 without one, or with an
    lstm / gru context layer)."""
    from pase_tpu_torch.nn import QRNN
    return len(module.rnn.layers) if isinstance(module.rnn, QRNN) else 0


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_device():
    import torch
    from pase_tpu_torch.precision import full_precision
    check(torch.cuda.is_available(),
          "no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    full_precision()
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s); {name}")
    print(smi.stdout.strip().splitlines()[0])
    return name


def phase_build():
    """The two kernel libraries, one nvcc each, started together."""
    from pase_tpu_torch.ops import conv, cuda_qrnn
    libs = [(cuda_qrnn.SOURCE, cuda_qrnn.library_path, cuda_qrnn.build),
            (conv.SOURCE, conv.library_path, conv.build)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        jobs = [pool.submit(build, True) for _, _, build in libs]
        for job in jobs:
            job.result()
    for source, path, _ in libs:
        print(f"[build] {os.path.relpath(path(), HERE)} from "
              f"{os.path.relpath(source, HERE)}")
    print(f"[build] both in {time.perf_counter() - t0:.2f} s")


def _seg_route_off(fn):
    """fn() with every seeded serving call routed to the one-thread-a-lane
    qrnn_pool_fwd (cuda_qrnn.SEG_LANES at 0), for comparison only."""
    from pase_tpu_torch.ops import cuda_qrnn
    saved = cuda_qrnn.SEG_LANES
    cuda_qrnn.SEG_LANES = 0
    try:
        return fn()
    finally:
        cuda_qrnn.SEG_LANES = saved


def _turns_ms(fns):
    """{name: mean of two CUDA-graph times}, timed in turns: the names in
    order, then in reverse order."""
    times = {k: [] for k in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(fns[name]())
    return {k: statistics.mean(v) for k, v in times.items()}


def reset_launches():
    from pase_tpu_torch.ops import conv, cuda_qrnn
    cuda_qrnn.reset_launches()
    conv.reset_launches()


def read_launches():
    from pase_tpu_torch.ops import conv, cuda_qrnn
    return {**cuda_qrnn.LAUNCHES, **conv.LAUNCHES}


def _kernel_ms(fn, batches=5, per_batch=10):
    """Median over batches of CUDA-event time per launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def _graph_ms(fn, batches=5, per_batch=20):
    """Median over batches of the CUDA-event time per launch of a CUDA
    graph of per_batch calls: the device's time alone, where a kernel
    takes less than its wrapper's host time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_batch):
            fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    del graph
    return statistics.median(times)


def _wall_ms(fn, device, reps=3):
    """Median host time of a synchronized call, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes, nops):
    """(least ms for the work on the card, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k2_route(shape):
    """The training pair's route at a QRNN shape (B, T, H), for the
    phases whose steps launch it: its kernels and chunking there."""
    from pase_tpu_torch.ops import cuda_qrnn
    b, t, h = shape
    chunks, len_fwd, len_bwd = cuda_qrnn.train_chunking(t)
    return (f"K2 at {list(shape)} ({b * h} lanes): the chunked pair "
            f"qrnn_pool_fwd_train_kernel, {-(-t // (chunks * len_fwd))} "
            f"segment(s) of {chunks} chunks of {len_fwd} steps, and "
            f"qrnn_pool_bwd_chunked_kernel, {-(-t // (chunks * len_bwd))} of "
            f"{chunks} x {len_bwd}")


def k1_eval(shape):
    """K1's entry point for an unseeded (eval) call at a QRNN shape (B, T,
    H): the route cuda_qrnn.forward_entry takes there."""
    from pase_tpu_torch.ops import cuda_qrnn
    b, t, h = shape
    return cuda_qrnn.forward_entry(b * h, False, t)


def k1_before(shape):
    """The kernel an unseeded call at (B, T, H) takes without the split
    kernel: the eval kernel on its lanes and steps, else the few-lane
    one."""
    from pase_tpu_torch.ops import cuda_qrnn
    b, t, h = shape
    lanes = b * h
    return ("eval" if lanes >= cuda_qrnn.EVAL_LANES
            or (lanes >= cuda_qrnn.EVAL_SHORT_LANES
                and t <= cuda_qrnn.EVAL_SHORT_STEPS) else "few")


def k1_calls(module, calls):
    """K1's launches for the encoder calls ``calls`` ({(B, T): calls}) of
    an encoder module: each takes the unseeded entry k1_eval names at B x
    H lanes (H the QRNN's width) and T steps, once per QRNN layer ({}
    without a QRNN)."""
    layers = qrnn_layers(module)
    out = {}
    if layers:
        hid = module.rnn.layers[0].linear.weight.shape[0] // 3
        for (b, t), n in calls.items():
            entry = k1_eval((b, t, hid))
            out[entry] = out.get(entry, 0) + layers * n
    return out


def _calls_sum(*calls):
    """{(B, T): calls} summed."""
    out = {}
    for c in calls:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def _few_check(y):
    """qrnn_pool_fwd_few on y: (max error against the plain version,
    against the plain version of its algebra at the library's tile, two
    calls bit for bit)."""
    import torch
    from pase_tpu_torch.ops import cuda_qrnn
    from pase_tpu_torch.ops import qrnn as plain
    b, t, h3 = y.shape
    tile = cuda_qrnn.few_chunking(b * (h3 // 3), t)
    check(tile == plain.few_tile(b * (h3 // 3), t), f"qrnn_pool_fwd_few's "
          f"tile {tile} != ops.qrnn.few_tile's at {list(y.shape)}")
    _, per, warps, chunk = tile
    hk, ck = cuda_qrnn.qrnn_pool_fwd_few(y)
    hk2, ck2 = cuda_qrnn.qrnn_pool_fwd_few(y)
    hr, cr = plain.qrnn_pool(y)
    hp, _, cp = plain.qrnn_pool_fwd_train_chunked_plain(
        y, chunk=chunk, chunks=per * warps, warp_chunks=per)
    return (max((hk - hr).abs().max().item(), (ck - cr).abs().max().item()),
            max((hk - hp).abs().max().item(), (ck - cp).abs().max().item()),
            bool(torch.equal(hk, hk2) and torch.equal(ck, ck2)))


def _few_turns(y):
    """The few-lane kernel, the streaming floor and the empty kernel in
    turns on y: {name: ms}."""
    from pase_tpu_torch.ops import cuda_qrnn
    return _turns_ms({
        "few": lambda: _graph_ms(lambda: cuda_qrnn.qrnn_pool_fwd_few(y)),
        "stream_floor": lambda: _graph_ms(lambda: cuda_qrnn.stream_floor(y)),
        "empty": lambda: _graph_ms(cuda_qrnn.empty_launch)})


def phase_kernel():
    """The serving forward kernels vs the plain version at each QRNN shape,
    the two serial ones also against each other, the eval, the split and
    the few-lane kernels also against the plain versions of their
    algebra; at FEW_SHAPES the few-lane kernel against both floors, also
    on slow and frozen gates; returns the summary rows and the empty
    kernel's time (the launch floor)."""
    import torch
    from pase_tpu_torch.kernel_variants import gates
    from pase_tpu_torch.ops import cuda_qrnn
    from pase_tpu_torch.ops import qrnn as plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, t, h in QRNN_SHAPES:
        y = torch.randn(b, t, 3 * h, device="cuda", generator=gen)
        c0 = torch.randn(b, h, device="cuda", generator=gen)
        errs = {}
        for name, fn in (
                ("split", lambda: cuda_qrnn.qrnn_pool_fwd_split(y)),
                ("few", lambda: cuda_qrnn.qrnn_pool_fwd_few(y)),
                ("seg", lambda: cuda_qrnn.qrnn_pool_fwd_seg(y)),
                ("loop", lambda: cuda_qrnn.qrnn_pool_fwd_loop(y)),
                ("eval", lambda: cuda_qrnn.qrnn_pool_fwd_eval(y)),
                ("seeded", lambda: cuda_qrnn.qrnn_pool(y, c0))):
            hk, ck = fn()
            hp, cp = plain.qrnn_pool(y, c0 if name == "seeded" else None)
            torch.cuda.synchronize()
            errs[name] = ((hk - hp).abs().max().item(),
                          (ck - cp).abs().max().item())
        # the eval kernel against its chunked plain version at the
        # library's chunking, and two calls bit for bit
        chunks, steps = cuda_qrnn.eval_chunking(t)
        he, ce = cuda_qrnn.qrnn_pool_fwd_eval(y)
        he2, ce2 = cuda_qrnn.qrnn_pool_fwd_eval(y)
        hp, _, cp = plain.qrnn_pool_fwd_train_chunked_plain(
            y, chunk=steps, chunks=chunks)
        eval_alg = max((he - hp).abs().max().item(),
                       (ce - cp).abs().max().item())
        eval_same = bool(torch.equal(he, he2) and torch.equal(ce, ce2))
        del he, ce, he2, ce2, hp, cp
        # the split kernel against the plain version of its algebra at the
        # library's tiling, and two calls bit for bit
        chunk, tile, tiles = cuda_qrnn.split_tiling(b * h, t)
        hs, cs = cuda_qrnn.qrnn_pool_fwd_split(y)
        hs2, cs2 = cuda_qrnn.qrnn_pool_fwd_split(y)
        hp, cp = plain.qrnn_pool_split_plain(y, tile=tile, chunk=chunk)
        split_alg = max((hs - hp).abs().max().item(),
                        (cs - cp).abs().max().item())
        split_same = bool(torch.equal(hs, hs2) and torch.equal(cs, cs2))
        del hs, cs, hs2, cs2, hp, cp
        # the few-lane kernel against the plain version of its algebra at
        # the library's tile, and two calls bit for bit
        _, few_alg, few_same = _few_check(y)
        # the two serial kernels, seeded and unseeded
        same = True
        for seed in (c0, None):
            hk, ck = cuda_qrnn.qrnn_pool_fwd_seg(y, seed)
            hl, cl = cuda_qrnn.qrnn_pool_fwd_loop(y, seed)
            same = same and bool(torch.equal(hk, hl) and torch.equal(ck, cl))
        half = t // 2
        h_full, c_full = cuda_qrnn.qrnn_pool(y, c0)
        h1, c1 = cuda_qrnn.qrnn_pool(y[:, :half].contiguous(), c0)
        h2, c2 = cuda_qrnn.qrnn_pool(y[:, half:].contiguous(), c1)
        streamed = bool(torch.equal(torch.cat([h1, h2], 1), h_full)
                        and torch.equal(c2, c_full))
        route = k1_eval((b, t, h))
        short = route.replace("qrnn_pool_fwd_", "")
        seeded_route = cuda_qrnn.forward_entry(b * h, True, t)
        before = k1_before((b, t, h))
        ms = _turns_ms({
            "split": lambda: _graph_ms(
                lambda: cuda_qrnn.qrnn_pool_fwd_split(y)),
            "loop": lambda: _graph_ms(
                lambda: cuda_qrnn.qrnn_pool_fwd_loop(y)),
            "eval": lambda: _graph_ms(
                lambda: cuda_qrnn.qrnn_pool_fwd_eval(y)),
            "seg": lambda: _graph_ms(
                lambda: cuda_qrnn.qrnn_pool_fwd_seg(y)),
            "few": lambda: _graph_ms(
                lambda: cuda_qrnn.qrnn_pool_fwd_few(y))})
        few = _few_turns(y) if (b, t, h) in FEW_SHAPES else {}
        plain_ms = _wall_ms(lambda: plain.qrnn_pool(y), "cuda")
        # y read once, h written once, c_T written once
        bound_ms, bound_by = bound(16 * b * t * h + 4 * b * h,
                                   FWD_OPS * b * t * h)
        err = max(max(e) for e in errs.values())
        print(f"[kernel] qrnn_pool y[{b},{t},{3 * h}]: max|dh|, max|dc_T| "
              + "; ".join(f"{k} {e[0]:.3e}, {e[1]:.3e}"
                          for k, e in errs.items())
              + f"; eval vs its chunked plain ({chunks} chunks of {steps}) "
              f"{eval_alg:.3e}, two calls bit for bit: {eval_same}; split "
              f"vs its plain algebra ({tiles} tiles of {tile} steps, chunks "
              f"of {chunk}) {split_alg:.3e}, two calls bit for bit: "
              f"{split_same}; few vs its plain algebra {few_alg:.3e}, two "
              f"calls bit for bit: {few_same}; "
              f"seg == loop bit for bit (seeded, unseeded): {same}; "
              f"block-streamed == full (seeded): {streamed}; "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in ms.items())
              + f" (CUDA graphs of 20, median of 5, in turns, mean of two); "
              f"bound {bound_ms:.5f} ms ({bound_by}): split "
              f"{bound_ms / ms['split']:.1%}, few "
              f"{bound_ms / ms['few']:.1%}, eval "
              f"{bound_ms / ms['eval']:.1%}, loop "
              f"{bound_ms / ms['loop']:.1%}; unseeded route {route} (the "
              f"route without the split kernel: {before}, {short} / {before} "
              f"{ms[short] / ms[before]:.3f}), seeded route "
              f"{seeded_route}; plain {plain_ms:.2f} ms (synchronized, "
              f"median of 3)")
        check(err <= KERNEL_ATOL,
              f"kernels vs plain at {(b, t, h)}: {err:.3e} > {KERNEL_ATOL}")
        check(eval_alg <= EVAL_ALG_ATOL, f"qrnn_pool_fwd_eval vs its chunked "
              f"plain at {(b, t, h)}: {eval_alg:.3e} > {EVAL_ALG_ATOL}")
        check(eval_same, f"qrnn_pool_fwd_eval: two calls differ at "
              f"{(b, t, h)}")
        check(split_alg <= EVAL_ALG_ATOL, f"qrnn_pool_fwd_split vs its plain "
              f"algebra at {(b, t, h)}: {split_alg:.3e} > {EVAL_ALG_ATOL}")
        check(split_same, f"qrnn_pool_fwd_split: two calls differ at "
              f"{(b, t, h)}")
        check(few_alg <= EVAL_ALG_ATOL, f"qrnn_pool_fwd_few vs its plain "
              f"algebra at {(b, t, h)}: {few_alg:.3e} > {EVAL_ALG_ATOL}")
        check(few_same, f"qrnn_pool_fwd_few: two calls differ at "
              f"{(b, t, h)}")
        check(streamed, f"block-streamed != full at {(b, t, h)}")
        check(same, f"qrnn_pool_fwd_seg != qrnn_pool_fwd at {(b, t, h)}")
        if few:
            print(f"[kernel] few-lane y[{b},{t},{3 * h}] (in turns, CUDA "
                  f"graphs of 20): the few-lane kernel {few['few']:.5f} ms, "
                  f"the streaming floor {few['stream_floor']:.5f} ms, the "
                  f"empty kernel "
                  f"{few['empty']:.5f} ms; few / streaming floor "
                  f"{few['few'] / few['stream_floor']:.2f}, few / launch "
                  f"floor {few['few'] / few['empty']:.2f}; byte bound "
                  f"{bound_ms:.5f} ms")
        rows.append({"shape": [b, t, h],
                     "few_err": max(errs["few"]), "few_alg": few_alg,
                     "few_ms": ms["few"],
                     "few_turns": few,
                     "split_err": max(errs["split"]), "split_alg": split_alg,
                     "split_ms": ms["split"], "route_ms": ms[short],
                     "before_ms": ms[before],
                     "seg_err": max(errs["seg"]),
                     "loop_err": max(max(errs["loop"]),
                                     max(errs["seeded"])),
                     "eval_err": max(errs["eval"]), "eval_alg": eval_alg,
                     "seg_ms": ms["seg"],
                     "loop_ms": ms["loop"], "eval_ms": ms["eval"],
                     "route": route, "before_route": before,
                     "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        del y, c0, h_full, h1, h2
    for (b, t, h), kind in QRNN_GATE_SHAPES:
        # gates whose carries decay slowly or never: the second run takes
        # every segment
        y = gates(torch.randn(b, t, 3 * h, device="cuda", generator=gen),
                  kind)
        chunk, tile, tiles = cuda_qrnn.split_tiling(b * h, t)
        hs, cs = cuda_qrnn.qrnn_pool_fwd_split(y)
        hs2, cs2 = cuda_qrnn.qrnn_pool_fwd_split(y)
        hr, cr = plain.qrnn_pool(y)
        hp, cp = plain.qrnn_pool_split_plain(y, tile=tile, chunk=chunk)
        err = max((hs - hr).abs().max().item(), (cs - cr).abs().max().item())
        alg = max((hs - hp).abs().max().item(), (cs - cp).abs().max().item())
        same = bool(torch.equal(hs, hs2) and torch.equal(cs, cs2))
        ms = _turns_ms({
            "split": lambda: _graph_ms(
                lambda: cuda_qrnn.qrnn_pool_fwd_split(y)),
            "few": lambda: _graph_ms(
                lambda: cuda_qrnn.qrnn_pool_fwd_few(y))})
        print(f"[kernel] qrnn_pool y[{b},{t},{3 * h}], {kind} gates: split "
              f"vs plain {err:.3e}, vs its plain algebra ({tiles} tiles of "
              f"{tile} steps) {alg:.3e}, two calls bit for bit: "
              f"{same}; split {ms['split']:.5f} ms, few "
              f"{ms['few']:.5f} ms (in turns), split / few "
              f"{ms['split'] / ms['few']:.3f}; unseeded route "
              f"{k1_eval((b, t, h))}")
        check(err <= KERNEL_ATOL, f"qrnn_pool_fwd_split vs plain at "
              f"{(b, t, h)}, {kind} gates: {err:.3e} > {KERNEL_ATOL}")
        check(alg <= EVAL_ALG_ATOL, f"qrnn_pool_fwd_split vs its plain "
              f"algebra at {(b, t, h)}, {kind} gates: {alg:.3e} > "
              f"{EVAL_ALG_ATOL}")
        check(same, f"qrnn_pool_fwd_split: two calls differ at {(b, t, h)}, "
              f"{kind} gates")
        del y, hs, cs, hs2, cs2, hr, cr, hp, cp
    for (b, t, h), kind in FEW_GATE_SHAPES:
        # the few-lane kernel has no second run: its time is the gates'
        # transcendentals', not their carries'
        y = gates(torch.randn(b, t, 3 * h, device="cuda", generator=gen),
                  kind)
        err, alg, same = _few_check(y)
        few = _few_turns(y)
        print(f"[kernel] few-lane y[{b},{t},{3 * h}], {kind} gates: vs plain "
              f"{err:.3e}, vs its plain algebra {alg:.3e}, two calls bit "
              f"for bit: {same}; in turns: few {few['few']:.5f} ms, "
              f"streaming floor {few['stream_floor']:.5f} ms, empty "
              f"{few['empty']:.5f} ms")
        check(err <= KERNEL_ATOL, f"qrnn_pool_fwd_few vs plain at "
              f"{(b, t, h)}, {kind} gates: {err:.3e} > {KERNEL_ATOL}")
        check(alg <= EVAL_ALG_ATOL, f"qrnn_pool_fwd_few vs its plain "
              f"algebra at {(b, t, h)}, {kind} gates: {alg:.3e} > "
              f"{EVAL_ALG_ATOL}")
        check(same, f"qrnn_pool_fwd_few: two calls differ at {(b, t, h)}, "
              f"{kind} gates")
        row = next(r for r in rows if r["shape"] == [b, t, h])
        row.setdefault("few_gates", {})[kind] = {"err": err, "alg": alg,
                                                 **few}
        del y
    torch.cuda.empty_cache()
    floor = _graph_ms(cuda_qrnn.empty_launch)
    print(f"[kernel] an empty kernel (one warp), the launch floor of the "
          f"shapes above: {floor:.5f} ms (CUDA graphs of 20, median of 5)")
    return rows, floor


def phase_encoder(device, cfg=PASEP_CFG, batch=8, samples=160000, reps=5,
                  label="encoder"):
    """PASE+ (or ``cfg``'s encoder) forward on ``device`` vs the same
    weights on the CPU, a frame every ``hop`` samples of the module.
    Returns (encoder, the encoder calls made on ``device``: {(B, frames):
    calls})."""
    import torch
    from pase_tpu_torch import wf_builder
    enc = wf_builder(cfg, device=device, seed=0)
    hop = enc.module.hop
    rng = np.random.RandomState(0)
    y = enc((rng.randn(1, 1, 100000) * 0.1).astype(np.float32))
    _sync(device)
    check(tuple(y.shape) == (1, enc.emb_dim, 100000 // hop),
          f"contract: {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "contract output not finite")
    print(f"[{label}] contract (1,1,100000) -> {tuple(y.shape)}")

    x = (rng.randn(batch, 1, samples) * 0.1).astype(np.float32)
    y = enc(x)
    _sync(device)
    check(tuple(y.shape) == (batch, enc.emb_dim, samples // hop),
          f"batch output {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "batch output not finite")
    ms = _wall_ms(lambda: enc(x), device, reps=reps)
    calls = {(1, 100000 // hop): 1, (batch, samples // hop): 2 + reps}
    audio_s = batch * samples / SR
    print(f"[{label}] ({batch},1,{samples}) -> {tuple(y.shape)}: forward "
          f"{ms:.2f} ms (synchronized, median of {reps}), "
          f"{audio_s / (ms / 1e3):.1f} audio-s/s")

    cpu = wf_builder(cfg, device="cpu", seed=0)
    cpu.module.load_state_dict(enc.module.state_dict())
    t0 = time.perf_counter()
    y_cpu = cpu(x)
    cpu_s = time.perf_counter() - t0
    rel = ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    print(f"[{label}] {device} vs cpu (plain path, {cpu_s:.2f} s): "
          f"max|dy|/max|y_cpu| {rel:.3e} (bound {ENCODER_REL})")
    check(rel <= ENCODER_REL, f"{device} vs cpu: {rel:.3e} > {ENCODER_REL}")
    return enc, calls


def _host_us(fn, calls):
    """Host us per call of ``calls`` unsynchronized calls (the kernel is
    shorter than its host side), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_operator(enc):
    """The registered QRNN operator (``torch.ops.pase_tpu_torch.
    qrnn_pool_fwd``) against the direct launch it wraps, in alternation:
    host us per call at [1,1000,1536] (the (1,1,160000) forward's QRNN
    input), and the forward through each at OP_PAIRS."""
    import torch
    from pase_tpu_torch.ops import cuda_qrnn
    operator = cuda_qrnn.qrnn_pool_fwd
    direct = cuda_qrnn._qrnn_pool_fwd_cuda      # below the dispatcher
    y = torch.randn(1, 1000, 1536, device="cuda")
    host = {"operator": [], "direct": []}
    for _ in range(5):
        host["operator"].append(_host_us(lambda: operator(y, None),
                                         OP_CALLS))
        host["direct"].append(_host_us(lambda: direct(y, None), OP_CALLS))
    op_us, direct_us = (statistics.median(host[k])
                        for k in ("operator", "direct"))
    print(f"[operator] host us per qrnn_pool_fwd call at [1,1000,1536] "
          f"({OP_CALLS} calls, median of 5, alternating): operator "
          f"{op_us:.2f}, direct launch {direct_us:.2f}, difference "
          f"{op_us - direct_us:+.2f}")
    rng = np.random.RandomState(2)
    boot = np.random.RandomState(0)
    try:
        for b, pairs in OP_PAIRS.items():
            x = torch.from_numpy((rng.randn(b, 1, 160000) * 0.1).astype(
                np.float32)).cuda()
            ms = {"operator": [], "direct": []}
            for i in range(pairs + 1):          # the first pair warms up
                order = (("operator", "direct") if i % 2 == 0
                         else ("direct", "operator"))
                for name in order:
                    cuda_qrnn.qrnn_pool_fwd = (operator if name == "operator"
                                               else direct)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    enc(x)
                    torch.cuda.synchronize()
                    if i:
                        ms[name].append((time.perf_counter() - t0) * 1e3)
            d = np.array(ms["operator"]) - np.array(ms["direct"])
            meds = np.median(boot.choice(d, (2000, len(d))), axis=1)
            lo, hi = np.percentile(meds, [2.5, 97.5]) * 1e3
            print(f"[operator] forward (1 QRNN call per layer) at "
                  f"({b},1,160000), {pairs} alternating pairs: operator "
                  f"{statistics.median(ms['operator']):.3f} ms, direct "
                  f"{statistics.median(ms['direct']):.3f} ms (medians); "
                  f"paired difference median {np.median(d) * 1e3:+.1f} us, "
                  f"95 % interval [{lo:+.1f}, {hi:+.1f}] us")
    finally:
        cuda_qrnn.qrnn_pool_fwd = operator


def write_wavs(root):
    """The four request wavs of WAV_SECONDS (seeded) and list.txt under
    root; returns {name: samples}."""
    from pase_tpu_torch.data.io import write_wav
    rng = np.random.RandomState(1)
    lengths = {}
    for i, sec in enumerate(WAV_SECONDS):
        n = int(round(sec * SR))
        write_wav(os.path.join(root, f"utt{i}.wav"),
                  (rng.randn(n) * 0.1).astype(np.float32))
        lengths[f"utt{i}"] = n
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("".join(f"{k}.wav\n" for k in lengths))
    return lengths


def phase_serve(enc, device, cfg=PASEP_CFG, chunk=160000, label="serve"):
    """forward-chunk over four wavs; returns the encoder calls ({(1,
    frames): calls}: one per window, plus one for the cross-check)."""
    from pase_tpu_torch import util_scripts
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.data.io import read_wav
    tmp = tempfile.mkdtemp(prefix="pase_chip_smoke_")
    try:
        lengths = write_wavs(tmp)
        npz = save_variables_npz(os.path.join(tmp, "FE_seed0.npz"),
                                 enc.module.state_dict())
        t0 = time.perf_counter()
        util_scripts.main([
            "forward-chunk", "--device", device, "--fe_cfg", cfg,
            "--fe_ckpt", npz, "--wav_list", os.path.join(tmp, "list.txt"),
            "--files_root", tmp, "--out_dir", os.path.join(tmp, "out"),
            "--chunk_size", str(chunk)])
        _sync(device)
        dt = time.perf_counter() - t0
        windows = 0
        for k, n in lengths.items():
            out = np.load(os.path.join(tmp, "out", f"{k}.npy"))
            check(out.shape == (enc.emb_dim, n // 160),
                  f"{k}: {out.shape} != {(enc.emb_dim, n // 160)}")
            check(bool(np.isfinite(out).all()), f"{k}: not finite")
            windows += -(-n // chunk)
        # the first request again through the in-memory encoder: the npz
        # round trip and the windowing give the same frames
        wav, _ = read_wav(os.path.join(tmp, "utt0.wav"))
        ref = enc(np.pad(wav, (0, chunk - len(wav)))[None, None])[0]
        ref = ref[:, :len(wav) // 160].cpu().numpy()
        got = np.load(os.path.join(tmp, "out", "utt0.npy"))
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        check(rel <= 1e-5, f"forward-chunk vs encoder: {rel:.3e}")
        audio_s = sum(lengths.values()) / SR
        print(f"[{label}] forward-chunk served {len(lengths)} requests "
              f"({audio_s:.1f} s of audio, {windows} windows) in {dt:.3f} s "
              f"incl. encoder build + weight load: "
              f"{len(lengths) / dt:.2f} requests/s, "
              f"{audio_s / dt:.1f} audio-s/s; vs in-memory encoder "
              f"{rel:.3e}")
        return {(1, chunk // enc.module.hop): windows + 1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_kernel_train():
    """qrnn_pool_fwd_train and qrnn_pool_bwd vs the plain version's
    autograd and vs the chunked plain versions (the kernels' algebra, at
    their chunking) at the train step's QRNN shapes, timed in CUDA graphs;
    returns one summary row per shape."""
    import torch
    from pase_tpu_torch.ops import cuda_qrnn
    from pase_tpu_torch.ops import qrnn as plain
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b, t, h in TRAIN_QRNN_SHAPES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)
        y, c0, dh, dct = rnd(b, t, 3 * h), rnd(b, h), rnd(b, t, h), rnd(b, h)
        chunks, len_fwd, len_bwd = cuda_qrnn.train_chunking(t)
        fwd_err = dy_abs = dy_rel = dc0_err = 0.0
        fwd_alg = dy_alg = 0.0
        for seed, dc_last in ((None, None), (c0, None), (None, dct),
                              (c0, dct)):
            hk, ck, ctk = cuda_qrnn.qrnn_pool_fwd_train(y, seed)
            hp, cp = plain.qrnn_pool_fwd_train(y, seed)
            dyk, dc0k = cuda_qrnn.qrnn_pool_bwd(y, ck, dh, dc_last, seed)
            yp = y.clone().requires_grad_()
            c0p = None if seed is None else seed.clone().requires_grad_()
            h_, ct_ = plain.qrnn_pool(yp, c0p)
            loss = torch.sum(h_ * dh)
            if dc_last is not None:
                loss = loss + torch.sum(ct_ * dc_last)
            grads = torch.autograd.grad(
                loss, [yp] + ([] if c0p is None else [c0p]))
            ha, ca, cta = plain.qrnn_pool_fwd_train_chunked_plain(
                y, seed, chunk=len_fwd, chunks=chunks)
            dya, dc0a = plain.qrnn_pool_bwd_chunked_plain(
                y, ck, dh, dc_last, seed, chunk=len_bwd, chunks=chunks)
            torch.cuda.synchronize()
            fwd_err = max(fwd_err, (hk - hp).abs().max().item(),
                          (ck - cp).abs().max().item(),
                          (ctk - cp[:, -1]).abs().max().item())
            err = (dyk - grads[0]).abs().max().item()
            dy_abs = max(dy_abs, err)
            dy_rel = max(dy_rel, err / max(1.0, grads[0].abs().max().item()))
            if seed is not None:
                dc0_err = max(dc0_err, (dc0k - grads[1]).abs().max().item(),
                              (dc0k - dc0a).abs().max().item())
            fwd_alg = max(fwd_alg, (hk - ha).abs().max().item(),
                          (ck - ca).abs().max().item(),
                          (ctk - cta).abs().max().item())
            dy_alg = max(dy_alg, (dyk - dya).abs().max().item()
                         / max(1.0, dya.abs().max().item()))
        # two calls, the same bits (no atomics, a fixed order)
        h1, c1, ct1 = cuda_qrnn.qrnn_pool_fwd_train(y, c0)
        dy1, dc01 = cuda_qrnn.qrnn_pool_bwd(y, c1, dh, dct, c0)
        h2, c2, ct2 = cuda_qrnn.qrnn_pool_fwd_train(y, c0)
        dy2, dc02 = cuda_qrnn.qrnn_pool_bwd(y, c2, dh, dct, c0)
        same = all(bool(torch.equal(u, v)) for u, v in (
            (h1, h2), (c1, c2), (ct1, ct2), (dy1, dy2), (dc01, dc02)))
        del h1, c1, dy1, h2, c2, dy2
        _, c, _ = cuda_qrnn.qrnn_pool_fwd_train(y)
        zeros = torch.zeros_like(dct)
        fwd_ms = _graph_ms(lambda: cuda_qrnn.qrnn_pool_fwd_train(y))
        bwd_ms = _graph_ms(lambda: cuda_qrnn.qrnn_pool_bwd(y, c, dh, zeros))
        fwd_plain = _wall_ms(lambda: plain.qrnn_pool_fwd_train(y), "cuda")
        bwd_plain = _wall_ms(lambda: plain.qrnn_pool_bwd(y, c, dh, zeros),
                             "cuda")
        lanes, steps = b * h, b * t * h
        # fwd_train: y read, h and c written, c_T written; bwd as on the
        # main path (no c0, autograd's zero dc_T): y, c, dh, dc_T read, dy
        # written
        fwd_bound, fwd_by = bound(20 * steps + 4 * lanes, FWD_OPS * steps)
        bwd_bound, bwd_by = bound(32 * steps + 4 * lanes, BWD_OPS * steps)
        print(f"[kernel-train] y[{b},{t},{3 * h}]: fwd_train max|dh|,|dc| "
              f"{fwd_err:.3e}; bwd max|dy - dy_plain| {dy_abs:.3e}, / max(1,"
              f" max|dy_plain|) {dy_rel:.3e}, max|dc0 - dc0_plain| "
              f"{dc0_err:.3e} (zero / c0 / dc_T / both); against the "
              f"chunked plain versions ({chunks} chunks of {len_fwd} / "
              f"{len_bwd} steps a segment) fwd {fwd_alg:.3e}, dy rel "
              f"{dy_alg:.3e}; two calls bit for bit: {same}; fwd_train "
              f"{fwd_ms:.4f} ms (bound {fwd_bound:.4f}, {fwd_by}: "
              f"{100 * fwd_bound / fwd_ms:.0f} %), plain {fwd_plain:.2f} ms; "
              f"bwd {bwd_ms:.4f} ms (bound {bwd_bound:.4f}, {bwd_by}: "
              f"{100 * bwd_bound / bwd_ms:.0f} %), plain {bwd_plain:.2f} ms "
              f"(kernels: CUDA graphs of 20, median of 5)")
        check(fwd_err <= KERNEL_ATOL and fwd_alg <= KERNEL_ATOL,
              f"fwd_train vs plain at {(b, t, h)}: {fwd_err:.3e}, "
              f"{fwd_alg:.3e}")
        check(dy_rel <= KERNEL_ATOL and dy_alg <= KERNEL_ATOL,
              f"bwd dy vs plain at {(b, t, h)}: {dy_rel:.3e}, {dy_alg:.3e}")
        check(dc0_err <= KERNEL_ATOL,
              f"bwd dc0 vs plain at {(b, t, h)}: {dc0_err:.3e}")
        check(same, f"two training calls differ at {(b, t, h)}")
        rows.append({"shape": [b, t, h], "fwd_err": fwd_err,
                     "dy_abs": dy_abs, "dy_rel": dy_rel, "dc0_err": dc0_err,
                     "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                     "fwd_plain_ms": fwd_plain, "bwd_plain_ms": bwd_plain,
                     "fwd_bound": (fwd_bound, fwd_by),
                     "bwd_bound": (bwd_bound, bwd_by)})
        del y, c0, dh, dct, c
    torch.cuda.empty_cache()
    return rows


def _state_bytes(tr):
    """(parameter bytes, Adam moment bytes) a trainer's process holds."""
    params = sum(p.numel() * p.element_size() for p in tr.model.parameters())
    moments = sum(v.numel() * v.element_size() for st in tr.opt.state.values()
                  for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
    return params, moments


def _grads(model):
    """{parameter name: its gradient as float64 on the CPU}."""
    import torch
    return {k: (p.grad.double().cpu() if p.grad is not None
                else torch.zeros(p.shape, dtype=torch.float64))
            for k, p in model.named_parameters()}


def phase_train_parity(tmp):
    """One full-width train step on the card vs the CPU plain path, same
    weights and batch. PReLU's derivative jumps at 0: an input that lies
    within rounding of 0 and that the two devices round to opposite sides
    moves the gradient by a whole output gradient there. So the step is
    also taken on the CPU with every PReLU on the card's side of the kink
    (grad_parity.prelu_signs), and the card's gradient is held to that
    one; the sign flips themselves must lie within rounding of 0."""
    import torch
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.grad_parity import (group_errors, prelu_signs,
                                            sign_flips, worst_leaves)
    from pase_tpu_torch.trainer import Trainer
    cfg = dict(backprop_mode="base", hop=160, bpe=100, epoch=1, batch_size=2,
               chunk_size=16000, fe_lr=1e-4, min_lr=4e-4, lr_mode="step",
               save_path=tmp)
    gpu = Trainer(PASEP_CFG, WORKERSP_CFG, cfg, device="cuda")
    cpu = Trainer(PASEP_CFG, WORKERSP_CFG, cfg, device="cpu")
    signed = Trainer(PASEP_CFG, WORKERSP_CFG, cfg, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    signed.model.load_state_dict(gpu.model.state_dict())
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=0)))
    x_gpu, x_cpu = {}, {}
    t0 = time.perf_counter()
    with prelu_signs(gpu.model, record=x_gpu):
        lg = gpu.train_step(raw)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    with prelu_signs(cpu.model, record=x_cpu):
        lc = cpu.train_step(raw)
    t_cpu = time.perf_counter() - t0
    with prelu_signs(signed.model,
                     force={k: x > 0 for k, x in x_gpu.items()}):
        signed.train_step(raw)
    loss_err = {k: abs(float(lg[k]) - float(lc[k])) / abs(float(lc[k]))
                for k in gpu.ordered_names}
    gg = _grads(gpu.model)
    natural = group_errors(gg, _grads(cpu.model))
    grad_err = group_errors(gg, _grads(signed.model))
    worst = worst_leaves(gg, _grads(signed.model), n=3)
    flips = sign_flips(x_gpu, x_cpu)
    far = max([r for _, r in flips.values()], default=0.0)
    print(f"[train] full-width step (PASE+, workers+, batch 2 x 16000): "
          f"card {t_gpu:.2f} s (first step), cpu {t_cpu:.2f} s; per-worker "
          f"|loss_gpu - loss_cpu| / |loss_cpu|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in loss_err.items()))
    print(f"[train] PReLU inputs of opposite sign on card and cpu: "
          f"{sum(n for n, _ in flips.values())} in {len(flips)} PReLU(s), "
          f"the largest |x| {far:.2e} of its module's max (bound "
          f"{FLIP_REL}); max|g_gpu - g_cpu| / max|g_cpu| per group: "
          + ", ".join(f"{g} {v:.2e}" for g, v in natural.items())
          + "; with the cpu's PReLUs on the card's side: "
          + ", ".join(f"{g} {v:.2e}" for g, v in grad_err.items())
          + f" (bound {TRAIN_GRAD_REL}); worst leaves: " + "; ".join(
              f"{k} {a:.2e} of its max" for k, a, _, _ in worst)
          + f" (bound {TRAIN_GRAD_REL})")
    check(all(v <= TRAIN_LOSS_REL for v in loss_err.values()),
          f"card vs cpu losses beyond {TRAIN_LOSS_REL}: {loss_err}")
    check(far <= FLIP_REL, f"a PReLU input {far:.3e} of its module's max "
          f"from 0 has opposite signs on card and cpu: {flips}")
    check(all(v <= TRAIN_GRAD_REL for v in grad_err.values()),
          f"card vs cpu gradients beyond {TRAIN_GRAD_REL}: {grad_err}")
    check(all(a <= TRAIN_GRAD_REL for _, a, _, _ in worst),
          f"card vs cpu gradient leaves beyond {TRAIN_GRAD_REL} of their "
          f"max: {worst}")
    del gpu, cpu, signed
    torch.cuda.empty_cache()
    return max(loss_err.values()), grad_err


def phase_train_cli(tmp):
    """The training CLI at batch 32 x 32000 for one epoch; returns (the
    trainer, launch counts of the run, {perf scalars})."""
    import math
    import torch
    from pase_tpu_torch import train as train_cli
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                           # the training path starts
    t0 = time.perf_counter()
    tr = train_cli.main([
        "--synthetic", "--net_cfg", WORKERSP_CFG, "--fe_cfg", PASEP_CFG,
        "--batch_size", str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK),
        "--epoch", "1", "--log_freq", "25", "--save_path", tmp])
    torch.cuda.synchronize()
    launches = read_launches()                 # ... and ends here
    wall = time.perf_counter() - t0
    recs = []
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    perf = [r for r in recs if r["split"] == "perf"]
    check(len(perf) == 1, f"expected one perf line, got {len(perf)}")
    losses = [(r["split"], r["step"], k, v) for r in recs
              if r["split"] in ("train", "eval") for k, v in r.items()
              if k not in ("t", "split", "step")]
    check(any(s == "train" for s, *_ in losses), "no train losses logged")
    check(any(s == "eval" for s, *_ in losses), "no eval losses logged")
    bad = [x for x in losses if not math.isfinite(x[3])]
    check(not bad, f"non-finite logged losses: {bad[:5]}")
    layers = len(tr.model.frontend.rnn.layers)
    steps, evals = tr.bpe, tr.cfg["va_bpe"]
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps,
                k1_eval(TRAIN_SHAPE): layers * evals}
    print(f"[launches] training path: {launches} (expected {expected}: "
          f"{layers} QRNN layer(s) x {steps} train steps, x {evals} eval "
          f"steps, the eval's K1 route at {list(TRAIN_SHAPE)})")
    check(launches == expected, f"training launches {launches} != "
          f"{expected}")
    npz = os.path.join(tmp, "FE_e0.npz")
    check(os.path.isfile(npz), "FE_e0.npz was not written")
    from pase_tpu_torch import wf_builder
    enc = wf_builder(PASEP_CFG, device="cuda").load_pretrained(npz)
    for k, v in tr.model.frontend.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            check(torch.equal(enc.module.state_dict()[k], v),
                  f"FE_e0.npz differs from the trained encoder at {k}")
    y = enc(np.random.RandomState(2).randn(1, 1, 16000).astype(np.float32))
    check(bool(torch.isfinite(y).all()), "FE_e0.npz encoder output")
    p = perf[0]
    last = [r for r in recs if r["split"] == "train"][-1]
    ev = [r for r in recs if r["split"] == "eval"][-1]
    print(f"[train] python -m pase_tpu_torch.train --synthetic (PASE+, "
          f"workers+, batch {TRAIN_BATCH} x {TRAIN_CHUNK}, 1 epoch of "
          f"{steps} steps + {evals} eval batches): {wall:.1f} s in all; "
          f"{p['steps_per_sec']:.3f} steps/s, {p['audio_sec_per_sec']:.1f} "
          f"audio-s/s; step {last['step']} total {last['total']:.4f}, eval "
          f"total {ev['total']:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; FE_e0.npz "
          f"loads into wf_builder")
    return tr, launches, p


def phase_profile(tr, what="train step"):
    """torch.profiler split of three train steps of a trainer (its
    quantizer's kernels in a span of their own)."""
    import contextlib
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.profiling import module_span, profile_train_steps
    batcher = DeviceSyntheticBatcher(tr.batch_size, tr.chunk_size, seed=7)
    vq = tr.model.frontend.quantizer
    with (contextlib.nullcontext() if vq is None
          else module_span(vq, "pase.quantizer")):
        prof = profile_train_steps(tr, [batcher.make_batch()
                                        for _ in range(5)])
    print_profile(prof, f"{what} (batch {TRAIN_BATCH} x {TRAIN_CHUNK})")
    return prof


def print_profile(prof, what):
    print(f"[profile] {what}: wall"
          f" {prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms"
          f" (kernel time; covered by a kernel {prof['covered_ms']:.2f}),"
          f" idle share {prof['idle_share']:.3f}")
    for span, kinds in sorted(prof["split"].items()):
        tot = sum(kinds.values())
        print(f"[profile]   {span}: {tot:.2f} ms = " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(kinds.items(),
                                              key=lambda kv: -kv[1])))


def check_distortions_card_vs_cpu(cfg, assets, what):
    """apply_distortions on the card against the CPU, the same batch and
    the same draws (drawn on the CPU, then copied); returns max|diff| /
    max|out_cpu| of the output and of the overlap label."""
    import torch
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.data.distortions import (apply_distortions,
                                                 draw_distortions)
    wav = DeviceSyntheticBatcher(TRAIN_BATCH, TRAIN_CHUNK, seed=3,
                                 device="cpu").make_batch()["chunk"]
    draws = draw_distortions(torch.Generator().manual_seed(5), TRAIN_BATCH,
                             TRAIN_CHUNK, cfg, assets)
    y_cpu, m_cpu = apply_distortions(wav, draws, cfg, assets)
    y_gpu, m_gpu = apply_distortions(wav.cuda(), draws.to("cuda"), cfg,
                                     assets.to("cuda"))
    rel = ((y_gpu.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    mask_err = (m_gpu.cpu() - m_cpu).abs().max().item()
    changed = (y_cpu != wav).any(dim=1).sum().item()
    print(f"[train-dist] apply_distortions card vs cpu ({what}, "
          f"{changed}/{TRAIN_BATCH} rows distorted): max|diff| / max|out| "
          f"{rel:.3e} (bound {DIST_REL}), overlap label max|diff| "
          f"{mask_err:.3e}")
    check(rel <= DIST_REL and mask_err <= DIST_REL,
          f"distortions card vs cpu ({what}): {rel:.3e}, label "
          f"{mask_err:.3e}")
    check(changed > 0, f"distortions ({what}) changed no row")
    return rel


def phase_train_dist(tmp, compute_dtype="bfloat16"):
    """bench.py's distorted PASE+ step on the card through
    pase_tpu_torch.bench, in ``compute_dtype``. Returns (trainer, launch
    counts of the timed steps, {perf scalars})."""
    import torch
    from pase_tpu_torch import bench
    from pase_tpu_torch.data.pipeline import make_prepare_fn
    b, t = TRAIN_BATCH, TRAIN_CHUNK
    tr, raws, stats, stats_s = bench.build("cuda", compute_dtype,
                                           save_path=tmp)
    check(all(np.isfinite(v[k]).all() and (v["std"] > 0).all()
              for v in stats.values() for k in ("mean", "std")),
          "compute_stats: non-finite or zero statistics")
    losses = []
    reset_launches()                      # the distorted step starts here
    rates = bench.measure(tr, raws, losses=losses)
    launches = read_launches()            # ... and ends here
    steps = len(losses)
    layers = len(tr.model.frontend.rnn.layers)
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps}
    print(f"[launches] distorted training step, {compute_dtype}: {launches}"
          f" (expected {expected}: {layers} QRNN layer(s) x {steps} steps); "
          + k2_route(TRAIN_SHAPE))
    check(launches == expected, f"distorted step ({compute_dtype}) "
          f"launches {launches} != {expected}")
    totals = torch.stack([torch.stack(list(d.values())) for d in losses])
    bad = (~torch.isfinite(totals)).sum().item()
    check(bad == 0, f"{bad} non-finite losses in the distorted step "
          f"({compute_dtype})")
    rate = statistics.median(rates)
    # the same trainer and protocol with the stack off: what it costs
    with_stack = tr.prepare
    tr.prepare = make_prepare_fn(tr.meta, stats=stats, hop=tr.hop)
    rate_off = statistics.median(bench.trials(tr, raws))
    tr.prepare = with_stack
    perf = {"steps_per_sec": rate, "audio_sec_per_sec": rate * b * t / SR,
            "spread": rates[-1] / rates[0] - 1.0, "rates": rates,
            "steps_per_sec_without": rate_off}
    print(f"[train-dist] bench step ({compute_dtype}; PASE+, workers+, "
          f"batch {b} x {t}, ZNorm stats from 2 batches of 8 in "
          f"{stats_s:.2f} s, reverb .5 overlap .1 noise .4 clip .2 chop "
          f".2): median of {bench.N_TRIALS} trials of {bench.N_MEAS} steps "
          f"{rate:.3f} steps/s, {perf['audio_sec_per_sec']:.1f} audio-s/s, "
          f"trial spread {perf['spread']:.1%} (rates "
          + ", ".join(f"{r:.3f}" for r in rates)
          + f"); total loss {float(totals[-1, -1]):.4f} after {steps} "
          f"steps, every loss finite; the same trainer without the stack "
          f"{rate_off:.3f} steps/s, so the stack costs "
          f"{1e3 / rate - 1e3 / rate_off:.2f} ms per step")
    if perf["spread"] > bench.CONTENTION_SPREAD:
        print(f"[train-dist] WARNING: trial spread {perf['spread']:.1%} "
              f"> {bench.CONTENTION_SPREAD:.0%}: the card or the host was "
              "likely shared during the trials")
    return tr, launches, perf


def check_bench_distortions():
    """The bench stack and all nine stages, card against CPU."""
    import torch
    from pase_tpu_torch import bench
    from pase_tpu_torch.data.distortions import build_resample_filters
    dcfg, assets = bench.bench_assets(TRAIN_CHUNK)
    check_distortions_card_vs_cpu(dcfg, assets, "the bench stack")
    rng = np.random.RandomState(1)
    every = assets._replace(
        resample_filters=build_resample_filters((2, 4)),
        bandrop_bank=torch.from_numpy(rng.randn(3, 129).astype(np.float32)),
        bandrop_lens=torch.tensor([129, 65, 33], dtype=torch.int32),
        downsample_bank=torch.from_numpy(rng.randn(1, 101).astype(
            np.float32)))
    every_cfg = dcfg._replace(
        reverb_p=1.0, overlap_p=1.0, overlap_reverb=True, noises_p=1.0,
        speed_p=1.0, speed_range=(-0.1, 0.1), resample_p=1.0,
        resample_factors=(2, 4), clip_p=1.0, chop_p=1.0, bandrop_p=1.0,
        downsample_p=1.0)
    check_distortions_card_vs_cpu(every_cfg, every, "all nine stages at p=1")


def phase_trajectory(tmp):
    """The 40-step gate on the card in float32 and bf16 against the JAX
    runs of the fixture."""
    from pase_tpu_torch import trajectory as T
    fixture = T.load_fixture(TRAJECTORY)
    verdicts = {}
    for precision in ("f32", "bf16"):
        t0 = time.perf_counter()
        traj = T.run_port(fixture, precision, "cuda",
                          save_path=os.path.join(tmp, precision))
        rows, ok = T.verdict(fixture, precision, traj)
        print(f"[trajectory] {precision}, {len(traj)} steps in "
              f"{time.perf_counter() - t0:.1f} s; per worker mean |port - "
              f"jax| / |jax| (max; the JAX one-ulp floor's mean, max): "
              + T.format_rows(rows))
        verdicts[precision] = (rows, ok)
    env = T.mean_max_rel(fixture["runs"]["f32"], fixture["runs"]["bf16"])
    print("[trajectory] JAX bf16 against JAX f32 (mean, max): " + ", ".join(
        f"{k} {m:.2e} {x:.2e}" for k, (m, x) in env.items()))
    for precision, (rows, ok) in verdicts.items():
        check(ok, f"trajectory gate ({precision}) failed: "
              + T.format_rows(rows))


def _resume_start(tmp):
    """Phase 11 in a process of its own: CUBLAS_WORKSPACE_CONFIG has to be
    set before cuBLAS starts, and the deterministic mode must not touch
    the other phases' timings. ``_resume_join`` waits for it."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    os.makedirs(tmp, exist_ok=True)
    return _background(["--resume-check"], os.path.join(tmp, "resume.log"),
                       env)


def _resume_join(started):
    text = _background_join(started, "resume check", 600)
    for line in text.splitlines():
        if line.startswith("[resume]"):
            print(line)


def resume_check():
    """2 steps, save, resume in a new Trainer, 2 more steps, against 4
    uninterrupted steps run twice; float32 and bf16 (Adam), and float32
    with RMSprop in both groups (phase 22), the gate's model and
    distortion stack on device batches. Returns 0 when bit for bit, or
    within twice the uninterrupted runs' own spread where that is not 0."""
    import warnings
    import torch
    from pase_tpu_torch import trajectory as T
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.precision import full_precision
    full_precision()
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    tmp = tempfile.mkdtemp(prefix="pase_chip_resume_")
    ok = True
    try:
        for label, precision, opt in (("f32", "f32", {}),
                                      ("bf16", "bf16", {}),
                                      ("f32 RMSprop", "f32",
                                       {"fe_opt": "RMSprop",
                                        "min_opt": "RMSprop"})):
            def trainer(name, **over):
                return T.make_trainer(precision, "cuda",
                                      os.path.join(tmp, label, name),
                                      bpe=2, epoch=2, log_freq=1,
                                      **opt, **over)

            def batcher():
                return DeviceSyntheticBatcher(T.BATCH, T.CHUNK, seed=1)

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                runs = []
                for name in ("whole_a", "whole_b"):
                    runs.append(trainer(name))
                    runs[-1].train_(batcher())
                cut = trainer("cut")
                cut.train_(batcher(), epochs=1)
                # another seed: the checkpoint's must win
                runs.append(trainer("cut", seed=99))
                runs[-1].train_(batcher())
            for tr in runs + [cut]:
                tr.logger.close()
            a, b_, r = ([logged[s] for s in (3, 4)] for logged in (
                _logged(os.path.join(tmp, label, n))
                for n in ("whole_a", "whole_b", "cut")))
            spread, diff = _max_rel(a, b_), _max_rel(a, r)
            same = all(torch.equal(runs[2].model.state_dict()[k], v)
                       for k, v in runs[0].model.state_dict().items()
                       if not k.endswith("num_batches_tracked"))
            ops = sorted({str(w.message).split(" does not")[0]
                          for w in caught
                          if "deterministic" in str(w.message)})
            bitwise = diff == 0.0 and same
            good = bitwise or (spread > 0 and diff <= 2 * spread)
            ok = ok and good
            verdict = ("bit for bit" if bitwise else
                       "within 2x the spread" if good else "FAIL")
            print(f"[resume] {label}: resumed steps 3-4 against the "
                  f"uninterrupted run: max |loss diff| / |loss| {diff:.3e},"
                  f" parameters {'bit-identical' if same else 'differ'}; "
                  f"two uninterrupted runs differ by {spread:.3e} (the "
                  f"card's run-to-run spread); ops without a deterministic "
                  f"implementation: {ops or 'none'}; {verdict}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0 if ok else 1


def _logged(path):
    """{step: {worker: loss}} of a run's metrics.jsonl train lines."""
    with open(os.path.join(path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return {r["step"]: {k: v for k, v in r.items()
                        if k not in ("t", "split", "step")}
            for r in recs if r["split"] == "train"}


def _max_rel(ref, other):
    return max(abs(o[k] - a[k]) / max(abs(a[k]), 1e-12)
               for a, o in zip(ref, other) for k in a)


def _conv_run(dtype, layers, expected):
    """conv_proto.forward over ``layers`` in ``dtype`` with the launch
    counts reset just before and read just after; checks them against
    ``expected`` (the conv kernels' counts; every other kernel 0) and
    returns (launches, measure's rows)."""
    from pase_tpu_torch import conv_proto
    from pase_tpu_torch.ops import conv
    import torch
    inputs = conv_proto.make_inputs(dtype, "cuda", layers=layers)
    reset_launches()                      # the conv_proto run starts here
    ys = conv_proto.forward(inputs)
    torch.cuda.synchronize()
    launches = read_launches()            # ... and ends here
    expected = {**{k: 0 for k in launches}, **expected}
    dt = str(dtype).replace("torch.", "")
    print(f"[launches] conv_proto run, {dt}: {launches} (expected "
          f"{expected}: one per layer)")
    check(launches == expected, f"conv_proto run ({dt}) launches "
          f"{launches} != {expected}")
    rows = conv_proto.measure(inputs, ys)
    del inputs, ys
    torch.cuda.empty_cache()
    for r in rows:
        print(f"[conv] {dt} " + conv_proto.format_row(r))
        rel = r["max_abs_err"] / r["max_abs_plain"]
        check(rel <= CONV_REL[dt], f"{conv.ROUTES[dtype]} vs plain at "
              f"{r['layer']} ({dt}): {rel:.3e} > {CONV_REL[dt]}")
    return launches, rows


def phase_conv():
    """python -m pase_tpu_torch.conv_proto's seven layers on the card, in
    bf16 (conv_s1_tc) and in float32 (conv_s1_tf32x3). Returns {dtype
    name: (launches of its run, its rows)}."""
    from pase_tpu_torch import conv_proto
    import torch
    layers = conv_proto.LAYERS
    out = {}
    for dtype, name in ((torch.bfloat16, "conv_s1_tc"),
                        (torch.float32, "conv_s1_tf32x3")):
        launches, rows = _conv_run(dtype, layers, {name: len(layers)})
        dt = str(dtype).replace("torch.", "")
        print(f"[conv] {dt} seven layers, {conv_proto.format_total(rows)}")
        slower = [r["layer"] for r in rows if r["ms"] > r["library_ms"]]
        print(f"[conv] layers where {name} is slower than cuDNN: "
              f"{slower or 'none'}")
        out[dt] = (launches, rows)
    l3 = out["float32"][1][CONV_L3]
    print(f"[conv] float32 L3 {l3['layer']}: conv_s1_tf32x3 {l3['ms']:.4f} "
          f"ms, cuDNN {l3['library_ms']:.4f} ms "
          f"({l3['library_ms'] / l3['ms']:.2f}x), bound {l3['bound_ms']:.4f}"
          f" ms ({l3['bound_ms'] / l3['ms']:.1%}), at 67 TFLOP/s "
          f"{l3['old_bound_ms']:.4f} ms")
    return out


def _conv_summary(name, launches, rows, paths=None):
    """The kernels-line row of a conv route over the seven layers: times
    and bounds summed; bound by what bounds the larger share of the sum."""
    total = sum(r["bound_ms"] for r in rows)
    by_ops = sum(r["bound_ms"] for r in rows
                 if r["bound_by"] == "operations")
    return _row(name, "pase_tpu_torch/csrc/conv_s1_tc.cu",
                "experiments/pallas_conv_proto.py:65", launches[name],
                max(r["max_abs_err"] for r in rows),
                sum(r["ms"] for r in rows), sum(r["plain_ms"] for r in rows),
                (total, "operations" if 2 * by_ops >= total else "bytes"),
                sum(r["library_ms"] for r in rows), paths)


def write_bench_dtrans_cfg(root):
    """bench.py's distortion stack as a --dtrans_cfg file: its IRs as .npy
    files, its noise and overlap rows as wavs, its probabilities."""
    from pase_tpu_torch import bench
    from pase_tpu_torch.data.io import write_wav
    dcfg, assets = bench.bench_assets(TRAIN_CHUNK)
    dirs = {k: os.path.join(root, k) for k in ("irs", "noise", "overlap")}
    for d in dirs.values():
        os.makedirs(d)
    for i, ir in enumerate(assets.ir_bank.numpy()):
        np.save(os.path.join(dirs["irs"], f"ir{i}.npy"), ir)
    for key, bank in (("noise", assets.noise_bank),
                      ("overlap", assets.overlap_bank)):
        for i, row in enumerate(bank.numpy()):
            write_wav(os.path.join(dirs[key], f"{key}{i}.wav"), row)
    js = {"reverb_data_root": dirs["irs"], "reverb_fmt": "npy",
          "reverb_p": dcfg.reverb_p, "noises_dir": dirs["noise"],
          "noises_snrs": list(dcfg.noises_snrs), "noises_p": dcfg.noises_p,
          "overlap_dir": dirs["overlap"],
          "overlap_snrs": list(dcfg.overlap_snrs),
          "overlap_p": dcfg.overlap_p, "clip_factors":
          list(dcfg.clip_factors), "clip_p": dcfg.clip_p,
          "chop_factors": [list(f) for f in dcfg.chop_factors],
          "max_chops": dcfg.max_chops, "chop_p": dcfg.chop_p}
    path = os.path.join(root, "bench_dist.cfg")
    with open(path, "w") as f:
        json.dump(js, f)
    return path


def _disk_run(args, label, synthetic_rate):
    """One epoch (or the resumed one) of the training CLI from the corpus;
    checks every logged loss and the QRNN launches. Returns (trainer,
    {perf line}, {feed line or {}})."""
    import math
    import torch
    from pase_tpu_torch import train as train_cli
    reset_launches()                       # the disk-fed path starts here
    t0 = time.perf_counter()
    tr = train_cli.main(args)
    torch.cuda.synchronize()
    launches = read_launches()             # ... and ends here
    wall = time.perf_counter() - t0
    save = args[args.index("--save_path") + 1]
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    perf = [r for r in recs if r["split"] == "perf"][-1]
    feed = next((r for r in recs if r["split"] == "feed"), {})
    bad = [(r["split"], r["step"], k) for r in recs
           if r["split"] in ("train", "eval") for k, v in r.items()
           if k not in ("t", "split", "step") and not math.isfinite(v)]
    check(not bad, f"disk-fed ({label}): non-finite losses {bad[:5]}")
    layers = len(tr.model.frontend.rnn.layers)
    steps, evals = tr.bpe, tr.cfg["va_bpe"]
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps,
                k1_eval(TRAIN_SHAPE): layers * evals}
    check(launches == expected, f"disk-fed ({label}) launches {launches} "
          f"!= {expected}")
    sps = perf["steps_per_sec"]
    ev = [r for r in recs if r["split"] == "eval"][-1]
    print(f"[disk] {label}: {steps} steps + {evals} eval batches, "
          f"{wall:.1f} s in all; {sps:.3f} steps/s = "
          f"{sps / synthetic_rate:.3f} x phase 8's synthetic bf16 rate "
          f"({synthetic_rate:.3f}); host wait for the next batch "
          f"{perf['feed_wait_ms']:.2f} ms/step, staging "
          f"{perf['stage_ms']:.2f} ms/step; eval total "
          f"{ev['total']:.4f}; launches {launches} (as expected: {layers} "
          f"QRNN layer(s) x {steps} steps, x {evals} eval steps)")
    return tr, perf, feed


def phase_disk(tmp, synthetic_rate):
    """Disk-fed training at full width from a seeded corpus on disk.
    Returns ({feed: steps/s}, the CLI's corpus arguments)."""
    import torch
    from pase_tpu_torch import make_trainset_statistics
    from pase_tpu_torch.data import device_corpus as DC
    from pase_tpu_torch.data.dataset import LibriSpeechTupleDataset, crop_at
    from pase_tpu_torch.data.io import read_wav, wav_len
    from pase_tpu_torch.data.pipeline import load_stats_pkl
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
    t0 = time.perf_counter()
    wav_root, data_cfg = write_synthetic_corpus(
        os.path.join(tmp, "corpus"), DISK_TRAIN_S, DISK_VALID_S, seed=0)
    with open(data_cfg) as f:
        cfg = json.load(f)
    names = [w["filename"] for w in cfg["train"]["data"]]
    lens = [wav_len(os.path.join(wav_root, n)) for n in names]
    n_short = sum(n < TRAIN_CHUNK for n in lens)
    print(f"[disk] corpus: {len(names)} train utterances of 1-16 s, "
          f"{cfg['train']['total_wav_dur'] / SR / 3600:.3f} h, "
          f"{2 * sum(lens) / 1e6:.1f} MB of PCM16, {n_short} shorter than the "
          f"{TRAIN_CHUNK / SR:.0f} s chunk; {len(cfg['valid']['data'])} "
          f"valid utterances; written in {time.perf_counter() - t0:.1f} s")
    check(n_short > 0, "the corpus has no utterance shorter than the chunk")
    stats_pkl = os.path.join(tmp, "stats.pkl")
    t0 = time.perf_counter()
    make_trainset_statistics.main([
        "--data_root", wav_root, "--data_cfg", data_cfg, "--net_cfg",
        WORKERSP_CFG, "--out_file", stats_pkl, "--batch_size",
        str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK), "--max_batches",
        "2"])
    stats = load_stats_pkl(stats_pkl)
    check(len(stats) == 9 and all(
        np.isfinite(v[k]).all() and (v["std"] > 0).all()
        for v in stats.values() for k in ("mean", "std")),
        f"statistics CLI: {sorted(stats)}, non-finite or zero std")
    print(f"[disk] python -m pase_tpu_torch.make_trainset_statistics: "
          f"{len(stats)} targets from 2 batches of {TRAIN_BATCH} in "
          f"{time.perf_counter() - t0:.1f} s")
    common = ["--data_root", wav_root, "--data_cfg", data_cfg, "--net_cfg",
              WORKERSP_CFG, "--fe_cfg", PASEP_CFG, "--batch_size",
              str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK),
              "--compute_dtype", "bfloat16", "--stats", stats_pkl,
              "--dtrans_cfg", write_bench_dtrans_cfg(tmp), "--log_freq", "25"]
    rates, feeds, saves = {}, {}, {}
    for label, flags in DISK_FEEDS:
        saves[label] = os.path.join(tmp, "disk_" + label.replace(" ", "_"))
        tr, perf, feeds[label] = _disk_run(
            common + flags + ["--epoch", "1", "--save_path", saves[label]],
            label, synthetic_rate)
        rates[label] = perf["steps_per_sec"]
        bpe, seed = tr.bpe, tr.seed
        del tr
        torch.cuda.empty_cache()
    feed = feeds["device corpus"]
    check(feed.get("corpus_bytes", 0) > 0, "no device corpus line logged")
    print(f"[disk] device corpus: {int(feed['corpus_bytes'])} bytes of int16 "
          f"on the card ({feed['corpus_bytes'] / 1e6:.1f} MB), built in "
          f"{feed['corpus_build_s']:.2f} s")

    # rows on the card are the wavs' samples at the starts drawn there
    ds = LibriSpeechTupleDataset(wav_root, data_cfg, "train")
    ref = DC.DeviceCorpusBatcher(ds, TRAIN_BATCH, TRAIN_CHUNK, seed=seed)
    batch = ref.make_batch(bpe)
    starts = ref.sample_starts(bpe).cpu().numpy()
    for role, key in enumerate(("chunk", "chunk_ctxt", "chunk_rand")):
        rows = batch[key].cpu().numpy()
        for r in range(TRAIN_BATCH):
            i = int(np.searchsorted(ref.offsets, starts[role, r], "right")
                    - 1)
            off = int(starts[role, r] - ref.offsets[i])
            wav, _ = read_wav(os.path.join(wav_root, names[i]))
            if len(wav) < TRAIN_CHUNK:
                wav = crop_at(wav, 0, TRAIN_CHUNK)
            check(np.array_equal(rows[r], wav[off:off + TRAIN_CHUNK]),
                  f"device corpus {key} row {r} != {names[i]}[{off}:]")
    print(f"[disk] device corpus rows of batch {bpe}: all "
          f"{3 * TRAIN_BATCH} equal the wav files' samples bit for bit at "
          "the starts read back from the card")

    # a second call resumes at step bpe and draws batch bpe of the
    # uninterrupted run
    seen = []
    make_batch = DC.DeviceCorpusBatcher.make_batch

    def recording(self, step):
        out = make_batch(self, step)
        if self.n_utts == len(names) and not seen:
            seen.append((step, {k: v.clone() for k, v in out.items()}))
        return out

    DC.DeviceCorpusBatcher.make_batch = recording
    try:
        tr, _, _ = _disk_run(common + ["--device_corpus", "--epoch", "2",
                                       "--save_path",
                                       saves["device corpus"]],
                             "device corpus, resumed at epoch 2",
                             synthetic_rate)
    finally:
        DC.DeviceCorpusBatcher.make_batch = make_batch
    check(tr.step == 2 * bpe, f"resumed run ended at step {tr.step}")
    step, first = seen[0]
    check(step == bpe, f"the resumed run drew batch {step} first, not {bpe}")
    check(all(torch.equal(first[k], batch[k]) for k in batch),
          "the resumed run's first batch is not the uninterrupted run's")
    print(f"[disk] resume: the second call resumed at step {bpe}, ended at "
          f"{tr.step}, and its first batch equals batch {bpe} of an "
          "uninterrupted feed bit for bit")
    del tr, ref, batch
    torch.cuda.empty_cache()
    return rates, common


def _stream_run(enc, wav, chunk):
    """One stream of wav [B, T] (on the card) in pushes of chunk samples;
    returns (frames, launch counts, pushes that reached the QRNN)."""
    from pase_tpu_torch.streaming import StreamingEncoder
    reset_launches()                        # a streaming path starts here
    st = StreamingEncoder(enc)
    outs = [st.push(wav[:, beg:beg + chunk])
            for beg in range(0, wav.shape[1], chunk)] + [st.flush()]
    _sync("cuda")
    launches = read_launches()              # ... and ends here
    return (np.concatenate([y.cpu().numpy() for y in outs if y is not None],
                           axis=2), launches, st.qrnn_calls)


def _stream_launches_ok(launches, layers, calls, what):
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_seg": layers * calls}
    check(launches == expected,
          f"{what}: launches {launches} != {expected}")
    return expected


def _push_profiles(enc, wav, what):
    """Device busy ms per steady 1 s push at B=1 (pushes 3-10 of a stream
    of wav [1, n] profiled, the first two run before) and K1's device ms,
    with K1 as the segmented kernel and as the one-thread-a-lane loop (the
    route forced), in turns."""
    from pase_tpu_torch.profiling import profile_calls
    from pase_tpu_torch.streaming import StreamingEncoder
    got = {}
    for label in ("seg", "loop", "loop", "seg"):
        st = StreamingEncoder(enc)
        calls = [lambda beg=beg: st.push(wav[:, beg:beg + SR])
                 for beg in range(0, wav.shape[1], SR)]
        prof = (_seg_route_off(lambda: profile_calls(calls, warmup=2))
                if label == "loop" else profile_calls(calls, warmup=2))
        k1 = sum(span.get("qrnn fwd", 0.0)
                 for span in prof["split"].values())
        got.setdefault(label, []).append(
            (prof["wall_ms"], prof["busy_ms"], k1))
    for label, runs in got.items():
        wall, busy, k1 = (statistics.mean(v) for v in zip(*runs))
        print(f"[stream] {what} steady 1 s push at B=1, K1 {label} "
              f"(torch.profiler, pushes 3-{wav.shape[1] // SR}, mean of two"
              f" turns): wall {wall:.3f} ms, device busy {busy:.4f} ms "
              f"(idle share {max(0.0, 1 - busy / wall):.3f}), K1 "
              f"{k1:.4f} ms = {k1 / busy:.1%} of busy; per turn busy "
              + ", ".join(f"{r[1]:.4f}" for r in runs))
        check(k1 > 0, f"{what}: no K1 kernel in the push's profile")


def phase_stream():
    """The streaming encoder on the card, forward-chunk --streaming, and
    the seeded segmented K1 at the push shapes against the
    one-thread-a-lane one. Returns ({path: launch counts} of the four
    streams and forward-chunk --streaming, {(B, T): K1's numbers})."""
    import torch
    from pase_tpu_torch import util_scripts, wf_builder
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.ops import cuda_qrnn
    from pase_tpu_torch.ops import qrnn as plain
    from pase_tpu_torch.streaming import StreamingEncoder
    enc = wf_builder(PASEP_CFG, device="cuda", seed=0)
    layers = len(enc.module.rnn.layers)
    rng = np.random.RandomState(13)
    n = STREAM_SECONDS * SR
    paths = {"stream": {}}
    for b in (1, 8):
        wav = torch.from_numpy((rng.randn(b, n) * 0.1).astype(np.float32))
        wav = wav.cuda()
        got = {}
        for label, chunk in STREAM_PUSHES:
            y, launches, calls = _stream_run(enc, wav, chunk)
            _stream_launches_ok(launches, layers, calls,
                                f"stream B={b}, {label} pushes")
            for k, v in launches.items():
                paths["stream"][k] = paths["stream"].get(k, 0) + v
            got[label] = y
            print(f"[launches] stream B={b}, {label} pushes: {launches} "
                  f"({calls} pushes reached the QRNN x {layers} layer(s))")
        ref = enc(wav[:, None]).cpu().numpy()
        (la, a), (lb, bb) = got.items()
        same = a.shape == bb.shape and np.array_equal(a, bb)
        rel = float(np.abs(a - ref).max() / np.abs(ref).max())
        print(f"[stream] PASE+ B={b}, {STREAM_SECONDS} s: {la} and {lb} "
              f"pushes bit for bit equal: {same}; streamed vs offline "
              f"max|d|/max|y| {rel:.3e} (bound rtol {STREAM_RTOL}, atol "
              f"{STREAM_ATOL})")
        check(same, f"stream B={b}: {la} and {lb} pushes differ")
        check(a.shape == ref.shape and np.allclose(
            a, ref, rtol=STREAM_RTOL, atol=STREAM_ATOL),
            f"stream B={b} vs offline beyond rtol {STREAM_RTOL} / atol "
            f"{STREAM_ATOL}: {rel:.3e}")
    print(f"[launches] the four streams: qrnn_pool_fwd_seg "
          f"{paths['stream']['qrnn_pool_fwd_seg']}")

    # ms per 1 s push at B=1, steady state (the first push primes)
    wav = torch.from_numpy((rng.randn(1, n) * 0.1).astype(np.float32))
    wav = wav.cuda()
    st = StreamingEncoder(enc)
    times = []
    for beg in range(0, n, SR):
        _sync("cuda")
        t0 = time.perf_counter()
        st.push(wav[:, beg:beg + SR])
        _sync("cuda")
        times.append((time.perf_counter() - t0) * 1e3)
    push_ms = statistics.median(times[1:])
    print(f"[stream] 1 s pushes at B=1: median {push_ms:.3f} ms per push "
          f"(pushes 2-{len(times)}; the first, priming, {times[0]:.3f} ms),"
          f" real-time factor {push_ms / 1e3:.5f}")
    _push_profiles(enc, wav, "PASE+")

    # forward-chunk --streaming over the four wavs
    tmp = tempfile.mkdtemp(prefix="pase_chip_stream_")
    try:
        from pase_tpu_torch.data.io import read_wav
        lengths = write_wavs(tmp)
        npz = save_variables_npz(os.path.join(tmp, "FE_seed0.npz"),
                                 enc.module.state_dict())
        reset_launches()
        t0 = time.perf_counter()
        util_scripts.main([
            "forward-chunk", "--streaming", "--device", "cuda", "--fe_cfg",
            PASEP_CFG, "--fe_ckpt", npz, "--wav_list",
            os.path.join(tmp, "list.txt"), "--files_root", tmp, "--out_dir",
            os.path.join(tmp, "out"), "--chunk_size", str(SR)])
        _sync("cuda")
        dt = time.perf_counter() - t0
        launches = read_launches()
        worst = 0.0
        calls = 0
        for k, m in lengths.items():
            out = np.load(os.path.join(tmp, "out", f"{k}.npy"))
            w, _ = read_wav(os.path.join(tmp, f"{k}.wav"))
            # the pushes of this file that reach the QRNN, counted by the
            # same stream in this process
            calls += _stream_run(enc, torch.from_numpy(w[None]).cuda(),
                                 SR)[2]
            ref = enc(w[None, None])[0].cpu().numpy()[:, :m // 160]
            check(out.shape == ref.shape, f"{k}: {out.shape} != {ref.shape}")
            check(np.allclose(out, ref, rtol=STREAM_RTOL, atol=STREAM_ATOL),
                  f"forward-chunk --streaming {k} vs offline")
            worst = max(worst, float(np.abs(out - ref).max()
                                     / np.abs(ref).max()))
        _stream_launches_ok(launches, layers, calls,
                            "forward-chunk --streaming")
        paths["stream_cli"] = launches
        print(f"[stream] forward-chunk --streaming (1 s pieces): "
              f"{len(lengths)} files in {dt:.3f} s, vs the offline encoder "
              f"of each whole file max|d|/max|y| {worst:.3e}; launches "
              f"{launches} ({calls} pushes reached the QRNN x {layers} "
              f"layer(s))")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the seeded serial K1 at the stream's shapes: the segmented kernel
    # and the one-thread-a-lane one, in turns
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    sm_hz = float(smi.stdout.split()[0]) * 1e6
    k1 = {}
    for b, t in PUSH_SHAPES:
        h = 512
        y = torch.randn(b, t, 3 * h, device="cuda")
        c0 = torch.randn(b, h, device="cuda")
        hk, ck = cuda_qrnn.qrnn_pool_fwd_seg(y, c0)
        hl, cl = cuda_qrnn.qrnn_pool_fwd_loop(y, c0)
        hp, cp = plain.qrnn_pool(y, c0)
        err = max((hk - hp).abs().max().item(), (ck - cp).abs().max().item())
        same = bool(torch.equal(hk, hl) and torch.equal(ck, cl))
        y1 = y[:, :1].contiguous()

        def timed(y_):
            return {"seg": lambda: _graph_ms(
                        lambda: cuda_qrnn.qrnn_pool_fwd_seg(y_, c0)),
                    "loop": lambda: _graph_ms(
                        lambda: cuda_qrnn.qrnn_pool_fwd_loop(y_, c0))}
        ms = _turns_ms(timed(y))
        one = _turns_ms(timed(y1))
        plain_ms = _wall_ms(lambda: plain.qrnn_pool(y, c0), "cuda")
        # y and c0 read once, h and c_T written once
        bound_ms, bound_by = bound(16 * b * t * h + 8 * b * h,
                                   FWD_OPS * b * t * h)
        # one lane's steps are a chain of dependent FMAs: the faster
        # kernel at one step, plus t - 1 more FMA latencies
        floor_ms = (min(one.values())
                    + (t - 1) * FMA_LATENCY_CYCLES / sm_hz * 1e3)
        # each kernel's own time per step beyond T=1
        slope = {k: (ms[k] - one[k]) / max(t - 1, 1) * 1e3 for k in ms}
        print(f"[stream] seeded serial K1 y[{b},{t},{3 * h}]: "
              f"qrnn_pool_fwd_seg {ms['seg']:.5f} ms, qrnn_pool_fwd (one "
              f"thread a lane) {ms['loop']:.5f} ms "
              f"({ms['loop'] / ms['seg']:.2f}x; CUDA graphs of 20, median "
              f"of 5, in turns, mean of two); bound {bound_ms:.5f} ms "
              f"({bound_by}): "
              f"{bound_ms / ms['seg']:.1%} of seg, {bound_ms / ms['loop']:.1%}"
              f" of loop; latency floor {floor_ms:.5f} ms (the faster at "
              f"T=1, seg {one['seg']:.5f} / loop {one['loop']:.5f} ms, + "
              f"{t - 1} FMAs of {FMA_LATENCY_CYCLES} cycles at "
              f"{sm_hz / 1e6:.0f} MHz): {floor_ms / ms['seg']:.1%} of seg, "
              f"{floor_ms / ms['loop']:.1%} of loop; per step beyond T=1, "
              f"each kernel against its own T=1: seg {slope['seg']:.4f} us, "
              f"loop {slope['loop']:.4f} us; bit for bit equal: {same}; "
              f"plain {plain_ms:.2f} ms; max|d| vs plain {err:.3e}")
        check(err <= KERNEL_ATOL, f"seeded K1 at {(b, t, h)}: {err:.3e}")
        check(same, f"seeded K1 at {(b, t, h)}: qrnn_pool_fwd_seg != "
              "qrnn_pool_fwd")
        k1[(b, t)] = {"err": err, "ms": ms["seg"], "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "floor_ms": floor_ms}
    del enc
    torch.cuda.empty_cache()
    return paths, k1


def _cli_seconds(argv):
    from pase_tpu_torch import util_scripts
    t0 = time.perf_counter()
    util_scripts.main(argv)
    _sync("cuda")
    return time.perf_counter() - t0


def phase_export():
    """export / serve-encode on the card; returns the launch counts of the
    exported programs' calls."""
    import torch
    from pase_tpu_torch import serving, wf_builder
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.streaming import stream_frames
    enc = wf_builder(PASEP_CFG, device="cuda", seed=0)
    layers = len(enc.module.rnn.layers)
    tmp = tempfile.mkdtemp(prefix="pase_chip_export_")
    try:
        lengths = write_wavs(tmp)
        npz = save_variables_npz(os.path.join(tmp, "FE_seed0.npz"),
                                 enc.module.state_dict())
        art = os.path.join(tmp, "artifact")
        common = ["--fe_cfg", PASEP_CFG, "--fe_ckpt", npz]
        export_s = _cli_seconds(
            ["export", "--device", "cuda", "--out_dir", art, "--chunk_sizes",
             EXPORT_BUCKETS, "--streaming_chunk", str(EXPORT_CHUNK)]
            + common)
        with open(os.path.join(art, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(art, "meta_streaming.json")) as f:
            smeta = json.load(f)
        check(meta["device"] == "cuda" and smeta["device"] == "cuda",
              f"artifact devices {meta['device']}, {smeta['device']}")
        print(f"[export] python -m pase_tpu_torch.util_scripts export: "
              f"{export_s:.2f} s in all; per bucket "
              + ", ".join(f"T={k} {v:.2f} s"
                          for k, v in meta["export_seconds"].items())
              + "; streaming (chunk " + str(EXPORT_CHUNK) + ") "
              + ", ".join(f"{k} {v:.2f} s"
                          for k, v in smeta["export_seconds"].items())
              + f"; halo {meta['halo']} samples; meta device "
              f"{meta['device']}")
        lst = ["--wav_list", os.path.join(tmp, "list.txt"), "--files_root",
               tmp]
        fc_s = _cli_seconds(["forward-chunk", "--device", "cuda",
                             "--chunk_size", "64000", "--out_dir",
                             os.path.join(tmp, "fc")] + common + lst)
        reset_launches()                # the serving programs start here
        single_s = _cli_seconds(["serve-encode", "--export_dir", art,
                                 "--out_dir", os.path.join(tmp, "single")]
                                + lst)
        single = read_launches()        # ... and end here
        calls = sum(-(-m // 64000) for m in lengths.values())
        expected = {**{k: 0 for k in single},
                    **k1_calls(enc.module, {(1, 64000 // 160): calls})}
        print(f"[launches] serve-encode (exported programs): {single} "
              f"(expected {expected}: {calls} program calls x {layers} "
              "layer(s))")
        check(single == expected, f"serve-encode launches {single}")
        batch_s = _cli_seconds(["serve-encode", "--export_dir", art,
                                "--batch_size", "4", "--out_dir",
                                os.path.join(tmp, "batch")] + lst)
        worst = 0.0
        for k, m in lengths.items():
            want = np.load(os.path.join(tmp, "fc", f"{k}.npy"))
            for mode in ("single", "batch"):
                got = np.load(os.path.join(tmp, mode, f"{k}.npy"))
                check(got.shape == want.shape == (enc.emb_dim, m // 160),
                      f"serve-encode {mode} {k}: {got.shape}")
                worst = max(worst, float(np.abs(got - want).max()))
                check(np.allclose(got, want, atol=SERVE_TOL,
                                  rtol=SERVE_TOL),
                      f"serve-encode {mode} {k} vs forward-chunk")
        nreq = len(lengths)
        print(f"[export] serve-encode {nreq} requests: single {single_s:.3f}"
              f" s ({nreq / single_s:.2f} requests/s), --batch_size 4 "
              f"{batch_s:.3f} s ({nreq / batch_s:.2f} requests/s); "
              f"forward-chunk --chunk_size 64000 {fc_s:.3f} s "
              f"({nreq / fc_s:.2f} requests/s), each call including its "
              f"set-up; max|serve - forward-chunk| {worst:.3e} (bound "
              f"{SERVE_TOL})")

        # the same requests in one process, the set-up apart: the loader
        # (params.npz and four programs) once, then the encodes, against
        # forward-chunk's windows through the in-memory encoder
        from pase_tpu_torch.data.io import read_wav
        wavs = [read_wav(os.path.join(tmp, f"{k}.wav"))[0] for k in lengths]
        t0 = time.perf_counter()
        srv = serving.ServingEncoder(art)
        load_s = time.perf_counter() - t0

        def windows(w, big=64000):
            return [enc(np.pad(w[i:i + big], (0, max(0, i + big - len(w))))
                        [None, None])[0].cpu().numpy()
                    for i in range(0, len(w), big)]

        rates = {}
        for name, fn in (("serve", srv.encode), ("forward-chunk", windows),
                         ("serve again", srv.encode),
                         ("forward-chunk again", windows)):
            fn(wavs[0])
            _sync("cuda")
            t0 = time.perf_counter()
            for w in wavs:
                fn(w)
            _sync("cuda")
            rates[name] = nreq / (time.perf_counter() - t0)
        print(f"[export] in one process: ServingEncoder load {load_s:.3f} "
              f"s; then requests/s "
              + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))

        # the serial route through the same exported bucket
        rng = np.random.RandomState(17)
        wide = (rng.randn(EXPORT_WIDE_BATCH, 64000) * 0.1).astype(
            np.float32)
        reset_launches()
        got = srv._call(64000, wide)
        _sync("cuda")
        wide_launches = read_launches()
        ref = enc(wide[:, None]).transpose(1, 2).cpu().numpy()
        err = float(np.abs(got - ref).max())
        expected = {**{k: 0 for k in wide_launches},
                    k1_eval((EXPORT_WIDE_BATCH, 64000 // 160, 512)): layers}
        print(f"[launches] exported T=64000 program at B="
              f"{EXPORT_WIDE_BATCH} ({EXPORT_WIDE_BATCH * 512} lanes): "
              f"{wide_launches}; vs the offline encoder max|d| {err:.3e}")
        check(wide_launches == expected,
              f"B={EXPORT_WIDE_BATCH} launches {wide_launches}")
        check(err <= SERVE_TOL, f"B={EXPORT_WIDE_BATCH}: {err:.3e}")

        # the streaming artifact against the in-process stream
        ssrv = serving.ServingStreamingEncoder(art)
        for b in (1, 4):
            w = (rng.randn(b, 4 * EXPORT_CHUNK) * 0.1).astype(np.float32)
            ssrv.reset()
            ys = [ssrv.push(w[:, i:i + EXPORT_CHUNK])
                  for i in range(0, w.shape[1], EXPORT_CHUNK)]
            got = np.concatenate(ys + [ssrv.flush()], axis=2)
            want = stream_frames(enc, torch.from_numpy(w).cuda(),
                                 EXPORT_CHUNK).cpu().numpy()
            same = got.shape == want.shape and np.array_equal(got, want)
            print(f"[export] streaming artifact (prime/step/flush, chunk "
                  f"{EXPORT_CHUNK}) B={b}: {got.shape[2]} frames, bit for "
                  f"bit equal to the in-process stream: {same}")
            check(same, f"streaming artifact B={b} != in-process stream")

        # an artifact exported on the CPU, served on the card
        small = {"kwidths": [65, 10, 4, 4], "strides": [1, 10, 4, 4],
                 "fmaps": [16, 16, 24, 24], "emb_dim": 24, "norm_out": True,
                 "rnn_pool": True, "rnn_dim": 24, "denseskips": True}
        cpu_art = os.path.join(tmp, "cpu_artifact")
        serving.export_encoder(wf_builder(small, device="cpu", seed=3),
                               cpu_art, chunk_sizes=(1600,))
        w = (rng.randn(3200) * 0.1).astype(np.float32)
        reset_launches()
        on_card = serving.ServingEncoder(cpu_art, device="cuda").encode(w)
        moved = read_launches()
        on_cpu = serving.ServingEncoder(cpu_art).encode(w)
        err = float(np.abs(on_card - on_cpu).max())
        print(f"[export] an artifact exported on the CPU (meta device "
              f"cpu), served on the card: launches {moved}; vs its CPU "
              f"frames max|d| {err:.3e}")
        check(moved[k1_eval((1, 1600 // 160, 24))] == 2, f"moved: {moved}")
        check(err <= SERVE_TOL, f"moved artifact: {err:.3e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del enc
    torch.cuda.empty_cache()
    return single


def phase_overlap():
    """workers+ plus an overlap head: one full-width step on the card and
    on the CPU with the same weights, batch and distortion draws."""
    import torch
    from pase_tpu_torch import bench
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.data.distortions import draw_distortions
    from pase_tpu_torch.model import parse_workers_cfg
    from pase_tpu_torch.trainer import Trainer
    b, t = 2, 16000
    workers = parse_workers_cfg(WORKERSP_CFG)
    workers["cls"].append({
        "name": "overlap", "type": "mlp", "num_outputs": 1, "dropout": 0,
        "hidden_size": 256, "hidden_layers": 1,
        "loss": "BCEWithLogitsLoss", "skip": False, "loss_weight": 1.0})
    dcfg, assets = bench.bench_assets(t)
    dcfg = dcfg._replace(overlap_p=1.0)
    cfg = dict(backprop_mode="base", hop=160, bpe=100, epoch=1,
               batch_size=b, chunk_size=t, fe_lr=1e-4, min_lr=4e-4,
               lr_mode="step", save_path=tempfile.mkdtemp(
                   prefix="pase_chip_overlap_"))
    try:
        gpu = Trainer(PASEP_CFG, workers, cfg, dist_cfg=dcfg,
                      dist_assets=assets, device="cuda")
        cpu = Trainer(PASEP_CFG, workers, cfg, dist_cfg=dcfg,
                      dist_assets=assets, device="cpu")
        cpu.model.load_state_dict(gpu.model.state_dict())
        raw = next(iter(SyntheticChunkBatcher(b, t, seed=4)))
        draws = draw_distortions(torch.Generator().manual_seed(6), b, t,
                                 dcfg, assets)
        label = cpu.prepare({k: torch.from_numpy(v) for k, v in raw.items()},
                            torch.Generator(), draws)["overlap"]
        reset_launches()                 # the overlap step starts here
        lg = gpu.train_step(raw, draws=draws)
        _sync("cuda")
        launches = read_launches()       # ... and ends here
        lc = cpu.train_step(raw, draws=draws)
        layers = len(gpu.model.frontend.rnn.layers)
        expected = {**{k: 0 for k in launches},
                    "qrnn_pool_fwd_train": layers, "qrnn_pool_bwd": layers}
        err = {k: abs(float(lg[k]) - float(lc[k])) / abs(float(lc[k]))
               for k in gpu.ordered_names}
        print(f"[overlap] workers+ plus overlap (BCE, overlap_p 1.0, "
              f"{float(label.mean()):.3f} of the frames labelled "
              f"overlapped), batch {b} x {t}: overlap loss card "
              f"{float(lg['overlap']):.6f}, cpu {float(lc['overlap']):.6f};"
              f" per-worker |loss_gpu - loss_cpu| / |loss_cpu|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
              + f" (bound {TRAIN_LOSS_REL})")
        print(f"[launches] overlap step: {launches} (expected {expected})")
        check(float(label.sum()) > 0, "the overlap label is all zeros")
        check(all(v <= TRAIN_LOSS_REL for v in err.values()),
              f"overlap step card vs cpu beyond {TRAIN_LOSS_REL}: {err}")
        check(launches == expected, f"overlap step launches {launches}")
    finally:
        shutil.rmtree(cfg["save_path"], ignore_errors=True)
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


def _variant_step(fe_cfg, workers, raw, what, tmp, gan_cfg=None,
                  setup=None, cfg_extra=None, step_kw=None, between=None,
                  compare=None, stats=None):
    """One train step of a model variant on the card and on the CPU, the
    same weights, batch and injected draws (``setup``, when given, is
    called on each trainer first; ``cfg_extra`` updates the trainers'
    cfg, ``stats`` are their ZNorm statistics, ``step_kw`` goes to both
    train_step calls, ``between(gpu, cpu)`` runs after the card's step,
    ``compare(gpu, cpu)`` after the checks below). The CPU's PReLUs take
    the
    card's side of their kink and its near-tie VQ codes the card's
    (grad_parity.prelu_signs, vq_codes); outside the ties the codes must
    agree. Per-worker losses ('vq' included; with a ``gan_cfg`` the G
    term and 'd_loss') within 1e-4 relative, gradients within 1e-3 of
    each group's largest; with a GAN, D's as ``_check_discriminator``
    says. Returns the card's launch counts of the step."""
    import torch
    from pase_tpu_torch.grad_parity import (code_flips, group_errors,
                                            prelu_signs, sign_flips,
                                            vq_codes, worst_leaves)
    from pase_tpu_torch.trainer import Trainer
    cfg = {**dict(backprop_mode="base", hop=160, bpe=100, epoch=1,
                  batch_size=2, chunk_size=16000, fe_lr=1e-4, min_lr=4e-4,
                  lr_mode="step", save_path=tmp), **(cfg_extra or {})}
    step_kw = step_kw or {}
    gpu = Trainer(fe_cfg, workers, cfg, device="cuda", gan_cfg=gan_cfg,
                  stats=stats)
    cpu = Trainer(fe_cfg, workers, cfg, device="cpu", gan_cfg=gan_cfg,
                  stats=stats)
    for tr in (gpu, cpu) if setup is not None else ():
        setup(tr)
    cpu.model.load_state_dict(gpu.model.state_dict())
    if gan_cfg is not None:
        cpu.discriminator.load_state_dict(gpu.discriminator.state_dict())
    x_gpu, x_cpu, c_gpu, c_cpu, forced = {}, {}, {}, {}, {}
    d_gpu, d_cpu = {}, {}
    reset_launches()                     # the variant's step starts here
    with prelu_signs(gpu.model, record=x_gpu), \
            vq_codes(gpu.model, record=c_gpu), \
            _g_term_signs(gpu.discriminator, record=d_gpu):
        lg = gpu.train_step(raw, **step_kw)
    _sync("cuda")
    launches = read_launches()           # ... and ends here
    if between is not None:
        between(gpu, cpu)
    with prelu_signs(cpu.model, record=x_cpu,
                     force={k: x > 0 for k, x in x_gpu.items()}), \
            vq_codes(cpu.model, record=c_cpu, forced=forced,
                     force={k: c for k, (c, _) in c_gpu.items()}), \
            _g_term_signs(cpu.discriminator, record=d_cpu,
                          force={k: x > 0 for k, x in d_gpu.items()}):
        lc = cpu.train_step(raw, **step_kw)
    x_gpu.update({"discriminator." + k: x for k, x in d_gpu.items()})
    x_cpu.update({"discriminator." + k: x for k, x in d_cpu.items()})
    names = [k for k in lg if k != "total"]
    loss_err = {k: abs(float(lg[k]) - float(lc[k])) / abs(float(lc[k]))
                for k in names}
    gg = _grads(gpu.model)
    grad_err = group_errors(gg, _grads(cpu.model))
    worst = worst_leaves(gg, _grads(cpu.model), n=3)
    flips = sign_flips(x_gpu, x_cpu)
    far = max([r for _, r in flips.values()], default=0.0)
    codes = code_flips(c_cpu, c_gpu)
    print(f"[variants-train] {what}, batch 2 x 16000, card vs cpu: "
          f"per-worker |loss_gpu - loss_cpu| / |loss_cpu| "
          + ", ".join(f"{k} {v:.2e}" for k, v in loss_err.items())
          + f" (bound {TRAIN_LOSS_REL}); PReLU inputs of opposite sign "
          f"{sum(n for n, _ in flips.values())}, the largest |x| {far:.2e}"
          f" of its module's max (bound {FLIP_REL}); VQ codes forced to "
          f"the card's at cpu ties: {sum(forced.values())} of "
          f"{sum(len(c) for c, _ in c_gpu.values())}, differing outside "
          f"ties: {sum(n for _, n in codes.values())}; max|g_gpu - g_cpu| "
          "/ max|g_cpu| per group: "
          + ", ".join(f"{g} {v:.2e}" for g, v in grad_err.items())
          + f" (bound {TRAIN_GRAD_REL}); worst leaves: " + "; ".join(
              f"{k} {a:.2e} of its max" for k, a, _, _ in worst))
    check(all(v <= TRAIN_LOSS_REL for v in loss_err.values()),
          f"{what}: card vs cpu losses beyond {TRAIN_LOSS_REL}: {loss_err}")
    check(far <= FLIP_REL, f"{what}: a PReLU input {far:.3e} of its "
          f"module's max from 0 has opposite signs: {flips}")
    check(all(n == 0 for _, n in codes.values()),
          f"{what}: VQ codes differ outside ties: {codes}")
    check(all(v <= TRAIN_GRAD_REL for v in grad_err.values()),
          f"{what}: card vs cpu gradients beyond {TRAIN_GRAD_REL}: "
          f"{grad_err}")
    check(all(a <= TRAIN_GRAD_REL for _, a, _, _ in worst),
          f"{what}: gradient leaves beyond {TRAIN_GRAD_REL}: {worst}")
    layers = qrnn_layers(gpu.model.frontend)
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": layers, "qrnn_pool_bwd": layers}
    print(f"[launches] {what} step: {launches} (expected {expected})")
    check(launches == expected, f"{what} step launches {launches}")
    if gan_cfg is not None:
        _check_discriminator(gpu, cpu, what)
    if compare is not None:
        compare(gpu, cpu)
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _g_term_signs(d, record=None, force=None):
    """grad_parity.prelu_signs for the first call of each of D's PReLUs in
    the block: the G term's call on the fake, through which the model's
    gradient flows (D's own step, which calls D again on the detached
    real and fake, runs as it is). Nothing without a D."""
    if d is None:
        yield
        return
    import torch
    from torch import nn
    seen = set()

    def hook(name):
        def fn(mod, inputs, out):
            if name in seen:
                return None
            seen.add(name)
            x = inputs[0]
            if record is not None:
                record[name] = x.detach().cpu()
            if force is None:
                return None
            slope = mod.weight.view(1, -1, *([1] * (x.dim() - 2)))
            return torch.where(force[name].to(x.device), x, slope * x)
        return fn

    hooks = [m.register_forward_hook(hook(n)) for n, m in d.named_modules()
             if isinstance(m, nn.PReLU)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def _check_discriminator(gpu, cpu, what):
    """D after one step on the card against the CPU: its gradients within
    1e-3 of their largest; its parameters within 1e-4 of their largest
    wherever the CPU's gradient is above D_LIVE_REL of its leaf's largest
    (Adam's first step moves a weight by lr g / (|g| + 1e-8), so where g
    lies within rounding of 0 either sign is right), else within 2 lr;
    its u within 1e-5."""
    dg = {k: p for k, p in gpu.discriminator.named_parameters()}
    top_g = max(p.grad.abs().max().item()
                for p in cpu.discriminator.parameters())
    top_p = max(p.detach().abs().max().item()
                for p in cpu.discriminator.parameters())
    lr = gpu.gan_cfg.get("lr", 5e-4)
    g_err = live_err = any_err = 0.0
    for k, pc in cpu.discriminator.named_parameters():
        pg = dg[k]
        g_err = max(g_err, (pg.grad.cpu() - pc.grad).abs().max().item())
        live = pc.grad.abs() >= D_LIVE_REL * pc.grad.abs().max()
        diff = (pg.detach().cpu() - pc.detach()).abs()
        live_err = max(live_err, diff[live].max().item())
        any_err = max(any_err, diff.max().item())
    u_err = max([(a.cpu() - b).abs().max().item() for a, b in zip(
        gpu.discriminator.buffers(), cpu.discriminator.buffers())],
        default=0.0)                    # ZDiscriminator has no SN conv
    print(f"[gan] {what}: D card vs cpu: max|dg| / max|g| "
          f"{g_err / top_g:.2e} (bound {TRAIN_GRAD_REL}); parameters after "
          f"the step, where |g| >= {D_LIVE_REL} of its leaf's max: max|dp| "
          f"/ max|p| {live_err / top_p:.2e} (bound {GAN_D_REL}), elsewhere "
          f"max|dp| {any_err:.2e} (bound 2 lr = {2 * lr:.1e}); max|du| "
          f"{u_err:.2e} (bound {GAN_U_ATOL})")
    check(g_err <= TRAIN_GRAD_REL * top_g, f"{what}: D gradients {g_err}")
    check(live_err <= GAN_D_REL * top_p, f"{what}: D parameters "
          f"{live_err}")
    check(any_err <= 2 * lr + GAN_D_REL * top_p,
          f"{what}: D parameters beyond 2 lr: {any_err}")
    check(u_err <= GAN_U_ATOL, f"{what}: D's u {u_err}")


def _variant_cli(fe_cfg, net_cfg, what, tmp, extra=()):
    """The training CLI on a variant at batch 32 x 32000 for one epoch;
    returns (trainer, launch counts, the perf line, the last train
    line)."""
    return _cli_run([
        "--synthetic", "--net_cfg", net_cfg, "--fe_cfg", fe_cfg,
        "--batch_size", str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK),
        "--epoch", "1", "--log_freq", "25", "--save_path", tmp]
        + list(extra), what, tmp)


def _cli_run(argv, what, tmp, eval_shape=TRAIN_SHAPE):
    """``python -m pase_tpu_torch.train`` in this process for one epoch:
    every logged loss finite, the training kernels once per QRNN layer
    per train step and K1's route at the eval's QRNN shape ``eval_shape``
    (``k1_eval``) once per layer per eval step. Returns (trainer, launch
    counts, the perf line, the last train line)."""
    import math
    import torch
    from pase_tpu_torch import train as train_cli
    reset_launches()                     # the CLI's training starts
    t0 = time.perf_counter()
    tr = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()           # ... and ends here
    wall = time.perf_counter() - t0
    tr.logger.close()
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    perf = [r for r in recs if r["split"] == "perf"]
    check(len(perf) == 1, f"{what}: {len(perf)} perf lines")
    logged = [(r["split"], r["step"], k, v) for r in recs
              if r["split"] in ("train", "eval") for k, v in r.items()
              if k not in ("t", "split", "step")]
    bad = [x for x in logged if not math.isfinite(x[3])]
    check(logged and not bad, f"{what}: non-finite losses {bad[:5]}")
    last = [r for r in recs if r["split"] == "train"][-1]
    layers = qrnn_layers(tr.model.frontend)
    steps, evals = tr.bpe, tr.cfg["va_bpe"]
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps,
                k1_eval(eval_shape): layers * evals}
    print(f"[launches] {what} training CLI: {launches} (expected "
          f"{expected}: {layers} QRNN layer(s) x {steps} train steps, x "
          f"{evals} eval steps)")
    check(launches == expected, f"{what} CLI launches {launches}")
    flags = " ".join(argv)
    print(f"[cli] {what}: python -m pase_tpu_torch.train {flags}: 1 "
          f"epoch of {steps} steps + {evals} eval "
          f"batches: {wall:.1f} s in all; {perf[0]['steps_per_sec']:.3f} "
          f"steps/s, {perf[0]['audio_sec_per_sec']:.1f} audio-s/s; step "
          f"{last['step']} total {last['total']:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return tr, launches, perf[0], last


def phase_variants_train(tmp, bf16_rate):
    """Phase 16: the VQ encoder, the v0.1 bank with SPC, and a Gap head
    trained on the card. Returns {path: launch counts}."""
    import torch
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.model import parse_workers_cfg
    paths = {}
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=0)))
    # (a) the VQ encoder with workers+, card vs cpu
    paths["vq_step"] = _variant_step(VQ_CFG, WORKERSP_CFG, raw,
                                     "VQ8192 resblocks + workers+",
                                     os.path.join(tmp, "vq_step"))
    # (b) its training CLI in bf16 with the bench distortion stack
    torch.cuda.reset_peak_memory_stats()
    dist = write_bench_dtrans_cfg(os.path.join(tmp, "vq_assets"))
    tr, paths["vq_training"], perf, last = _variant_cli(
        VQ_CFG, WORKERSP_CFG, "VQ8192 resblocks + workers+",
        os.path.join(tmp, "vq_cli"),
        ["--compute_dtype", "bfloat16", "--dtrans_cfg", dist])
    rate = perf["steps_per_sec"]
    print(f"[variants-train] VQ8192 bf16 with the bench stack: "
          f"{rate:.3f} steps/s against phase 8's PASE+ bf16 bench step "
          f"{bf16_rate:.3f} ({rate / bf16_rate:.3f}x); last step's vq "
          f"{last['vq']:.4f}, vq_perplexity {last['vq_perplexity']:.1f} of "
          f"8192 codes")
    phase_profile(tr, "VQ8192 train step, bf16, bench stack")
    del tr
    torch.cuda.empty_cache()
    # (c) the v0.1 bank (workers.cfg: SPC) on PASE.cfg
    rng = np.random.RandomState(3)
    t = rng.randint(22, 79)
    spc = dict(raw, spc_idx=np.array([t, rng.randint(t + 16, 95),
                                      rng.randint(5, t - 16)], np.int64))
    paths["v01_step"] = _variant_step(V01_CFG, V01_WORKERS, spc,
                                      "PASE v0.1 (PASE.cfg + workers.cfg)",
                                      os.path.join(tmp, "v01_step"))
    tr, paths["v01_training"], _, _ = _variant_cli(
        V01_CFG, V01_WORKERS, "PASE v0.1 (PASE.cfg + workers.cfg)",
        os.path.join(tmp, "v01_cli"))
    del tr
    torch.cuda.empty_cache()
    # (d) workers+ plus a Gap head
    workers = parse_workers_cfg(WORKERSP_CFG)
    workers["cls"].append({
        "name": "gap", "type": "mlp", "num_outputs": 1, "dropout": 0,
        "hidden_size": 256, "hidden_layers": 1, "loss": "MSELoss",
        "skip": False, "loss_weight": 1.0})
    gap = dict(raw, gap_idx=rng.randint(0, 100, (2, 2)).astype(np.int64))
    paths["gap_step"] = _variant_step(PASEP_CFG, workers, gap,
                                      "PASE+ workers+ plus gap",
                                      os.path.join(tmp, "gap_step"))
    return paths


def _recipe_cli_argv(tmp, gan=True, script=GAN_RECIPE, values=None):
    """A recipe's flags for a --synthetic run of one epoch: the corpus,
    statistics and distortion flags dropped (their files are not in the
    repository), cfg paths under this checkout, without ``gan`` the
    --gan_cfg dropped too, and ``values`` ({flag: value}) replacing the
    recipe's."""
    argv, out = recipe_argv(script), []
    drop = RECIPE_DATA_FLAGS + (() if gan else ("--gan_cfg",))
    values = {"--epoch": "1", **(values or {})}
    i = 0
    while i < len(argv):
        flag = argv[i]
        if flag in drop:
            i += 2
            continue
        if flag in values:
            out += [flag, values[flag]]
            i += 2
            continue
        value = argv[i + 1] if i + 1 < len(argv) else None
        if value is not None and value.startswith("cfg/"):
            out += [flag, os.path.join(HERE, value)]
            i += 2
            continue
        out.append(flag)
        i += 1
    return out + ["--synthetic", "--log_freq", "25", "--save_path", tmp]


def phase_gan(tmp):
    """Phase 18: the GAN workers on the card. Returns {path: launch
    counts}."""
    import torch
    from pase_tpu_torch.checkpoint import train_state_to_tree
    from pase_tpu_torch.data.dataset import (DeviceSyntheticBatcher,
                                             SyntheticChunkBatcher)
    from pase_tpu_torch.profiling import profile_train_steps
    from pase_tpu_torch.trainer import Trainer
    paths = {}
    argv = recipe_argv(GAN_RECIPE)
    gan = json.loads(argv[argv.index("--gan_cfg") + 1])
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=8)))
    # (a) the recipe's wave GAN at full width, one step card vs cpu
    paths["gan_step"] = _variant_step(
        PASEP_CFG, WORKERSP_CFG, raw, "PASE+ workers+ wave GAN (the "
        "recipe's gan_cfg)", os.path.join(tmp, "gan_step"), gan_cfg=gan)
    # (b) the z GAN with the cchunk prior
    paths["gan_z_step"] = _variant_step(
        PASEP_CFG, WORKERSP_CFG, raw, "PASE+ workers+ z GAN, cchunk prior",
        os.path.join(tmp, "gan_z_step"), gan_cfg=GAN_Z_CFG)
    # (c) the recipe through the CLI, with and without its gan_cfg, in
    # turns in this process; (f) three steps of each profiled: D's span
    # against the rest
    rates, profs = {}, {}
    for label, with_gan in (("recipe + gan_cfg", True),
                            ("recipe without gan_cfg", False)):
        run = os.path.join(tmp, "cli_gan" if with_gan else "cli_plain")
        torch.cuda.reset_peak_memory_stats()
        tr, launches, perf, last = _cli_run(
            _recipe_cli_argv(run, with_gan), label, run,
            (3 * 16, TRAIN_CHUNK // 160, 512))
        paths["gan_cli" if with_gan else "gan_cli_plain"] = launches
        rates[label] = perf["steps_per_sec"]
        batcher = DeviceSyntheticBatcher(tr.batch_size, tr.chunk_size,
                                         seed=7)
        profs[label] = profile_train_steps(tr, [batcher.make_batch()
                                                for _ in range(5)])
        print_profile(profs[label], f"{label}: a train step (batch "
                      f"{tr.batch_size} x {tr.chunk_size}, bf16)")
        if with_gan:
            check(tr.discriminator is not None and "d_loss" in last
                  and "cchunk_g" in last, "the recipe ran without its GAN")
            print(f"[gan] recipe step {last['step']}: cchunk_g "
                  f"{last['cchunk_g']:.4f}, d_loss {last['d_loss']:.4f}")
            gan_tr = tr
        else:
            del tr
    gan_rate, plain_rate = (rates["recipe + gan_cfg"],
                            rates["recipe without gan_cfg"])
    prof = profs["recipe + gan_cfg"]
    d_ms = sum(prof["split"].get("pase.discriminator", {}).values())
    share = d_ms / prof["busy_ms"]
    print(f"[gan] the recipe (batch 16 x 32000, bf16): {gan_rate:.3f} "
          f"steps/s with its gan_cfg, {plain_rate:.3f} without "
          f"({gan_rate / plain_rate:.3f}x); D's span pase.discriminator "
          f"{d_ms:.2f} of {prof['busy_ms']:.2f} busy ms per step "
          f"({share:.3f}); busy ms with / without "
          f"{prof['busy_ms']:.2f} / "
          f"{profs['recipe without gan_cfg']['busy_ms']:.2f}, idle share "
          f"{prof['idle_share']:.3f} / "
          f"{profs['recipe without gan_cfg']['idle_share']:.3f}, kernels "
          f"launched per step {sum(prof['launches'].values()):.0f} / "
          f"{sum(profs['recipe without gan_cfg']['launches'].values()):.0f}"
          f", {prof['launches'].get('pase.discriminator', 0):.0f} of them "
          "in D's span")
    check(d_ms > 0, "no device time in the discriminator's span")
    # (d) save / resume of the GAN train state
    gan_tr.save(0)
    back = Trainer(PASEP_CFG, WORKERSP_CFG, gan_tr.cfg, device="cuda",
                   gan_cfg=gan)
    check(back.try_resume() == gan_tr.step, "resume step")
    a, b = train_state_to_tree(gan_tr), train_state_to_tree(back)
    differ = [k for k in a if k not in b or not np.array_equal(a[k], b[k])]
    check(set(a) == set(b) and not differ,
          f"resumed GAN state differs at {differ[:5]}")
    d_keys = sum(k.startswith("d_") for k in a)
    nxt = DeviceSyntheticBatcher(gan_tr.batch_size, gan_tr.chunk_size,
                                 seed=9).make_batch()
    la, lb = gan_tr.train_step(nxt), back.train_step(nxt)
    cont = max(abs(float(la[k]) - float(lb[k])) / max(abs(float(la[k])),
                                                      1e-30) for k in la)
    print(f"[gan] save / resume at step {back.step - 1}: {len(a)} leaves "
          f"({d_keys} of D: params, u, Adam) bit for bit; the next step "
          f"resumed vs uninterrupted: max relative loss difference "
          f"{cont:.2e} (bound {TRAIN_LOSS_REL}; cuDNN's run-to-run "
          "spread)")
    check(cont <= TRAIN_LOSS_REL, f"resumed GAN step: {cont:.3e}")
    del gan_tr, back
    torch.cuda.empty_cache()
    # (e) PASE+ with spectral- and weight-normalized FeBlocks
    with open(PASEP_CFG) as f:
        base = json.load(f)
    for norm in ("snorm", "wnorm"):
        cfg = dict(base, norm_type=norm, sincnet=False)
        reset_launches()                 # this encoder's path starts
        enc, calls = phase_encoder("cuda", cfg=cfg, reps=3)
        launches = read_launches()       # ... and ends here
        expected = {**{k: 0 for k in launches},
                    **k1_calls(enc.module, calls)}
        print(f"[gan] PASE+ with {norm} FeBlocks (no sinc layer: it takes "
              f"no reparameterization): launches {launches}")
        check(launches == expected, f"{norm} encoder launches {launches}")
        paths[f"{norm}_serving"] = launches
        del enc
    torch.cuda.empty_cache()
    return paths


def _vq_stream_check(enc, wav, got, what):
    """Streamed frames against the offline encoder: the codes equal
    outside the offline side's ties, and where they are equal the frames
    within rtol / atol. Returns (max relative difference, tie codes)."""
    import torch
    from pase_tpu_torch.grad_parity import vq_codes
    rec = {}
    with torch.no_grad(), vq_codes(enc.module, record=rec):
        ref = enc(wav[:, None]).cpu().numpy()
    (codes, ties), = rec.values()
    check(got.shape == ref.shape, f"{what}: {got.shape} != {ref.shape}")
    vq = enc.module.quantizer
    with torch.no_grad():
        mine = vq.nearest(torch.from_numpy(got).cuda().transpose(1, 2)
                          .reshape(-1, got.shape[1])).cpu()
    differ = mine != codes
    check(not bool((differ & ~ties).any()),
          f"{what}: codes differ outside ties at "
          f"{int((differ & ~ties).sum())} frames")
    keep = (~differ).numpy().reshape(got.shape[0], got.shape[2])
    a = np.transpose(got, (0, 2, 1))[keep]
    b = np.transpose(ref, (0, 2, 1))[keep]
    check(np.allclose(a, b, rtol=STREAM_RTOL, atol=STREAM_ATOL),
          f"{what} vs offline beyond rtol {STREAM_RTOL} / atol "
          f"{STREAM_ATOL}")
    return float(np.abs(a - b).max() / np.abs(b).max()), int(differ.sum())


def phase_variants_serve():
    """Phase 17: the VQ encoder served, streamed and exported on the card,
    a steady push profiled with K1 as the segmented kernel and as the
    one-thread-a-lane one. Returns {path: launch counts}."""
    import torch
    from pase_tpu_torch import serving, wf_builder
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.grad_parity import vq_codes
    from pase_tpu_torch.profiling import module_span, profile_calls
    from pase_tpu_torch.streaming import StreamingEncoder, stream_frames
    paths = {}
    enc = wf_builder(VQ_CFG, device="cuda", seed=0)
    cpu = wf_builder(VQ_CFG, device="cpu", seed=0)
    cpu.module.load_state_dict(enc.module.state_dict())
    layers = len(enc.module.rnn.layers)
    rng = np.random.RandomState(0)
    x = (rng.randn(8, 1, 160000) * 0.1).astype(np.float32)
    reset_launches()                     # the VQ serving path starts here
    rec, forced = {}, {}
    with vq_codes(enc.module, record=rec):
        y = enc(x)
    _sync("cuda")
    ms = _wall_ms(lambda: enc(x), "cuda", reps=5)
    calls = {(8, 1000): 7}
    with vq_codes(cpu.module, force={k: c for k, (c, _) in rec.items()},
                  forced=forced):
        y_cpu = cpu(x)
    rel = ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    check(tuple(y.shape) == (8, 256, 1000), f"VQ forward {tuple(y.shape)}")
    print(f"[variants-serve] VQ8192 resblocks (8,1,160000) -> "
          f"{tuple(y.shape)}: forward {ms:.2f} ms (synchronized, median of"
          f" 5), {8 * 10 / (ms / 1e3):.1f} audio-s/s; card vs cpu max|dy|/"
          f"max|y_cpu| {rel:.3e} (bound {ENCODER_REL}), the cpu's codes "
          f"forced to the card's at {sum(forced.values())} ties of 8000")
    check(rel <= ENCODER_REL, f"VQ card vs cpu: {rel:.3e}")
    del cpu, y_cpu
    calls = _calls_sum(calls, phase_serve(enc, "cuda", cfg=VQ_CFG,
                                          label="variants-serve"))
    paths["vq_serving"] = read_launches()    # ... and ends here
    expected = {**{k: 0 for k in paths["vq_serving"]},
                **k1_calls(enc.module, calls)}
    print(f"[launches] VQ serving path: {paths['vq_serving']} (expected "
          f"{expected}: {calls} encoder calls)")
    check(paths["vq_serving"] == expected,
          f"VQ serving launches {paths['vq_serving']}")
    vq = enc.module.quantizer
    with module_span(vq, "pase.quantizer"), torch.no_grad():
        prof = profile_calls([lambda: enc(x)] * 4)
    print_profile(prof, "VQ8192 forward (8,1,160000); the trunk is "
                  "'other'")

    # streams: B=1 and B=8, 1 s and 100 ms pushes
    n = STREAM_SECONDS * SR
    paths["vq_stream"] = {}
    for b in (1, 8):
        wav = torch.from_numpy((rng.randn(b, n) * 0.1).astype(
            np.float32)).cuda()
        got = {}
        for label, chunk in STREAM_PUSHES:
            frames, launches, pushes = _stream_run(enc, wav, chunk)
            _stream_launches_ok(launches, layers, pushes,
                                f"VQ stream B={b}, {label} pushes")
            for k, v in launches.items():
                paths["vq_stream"][k] = paths["vq_stream"].get(k, 0) + v
            got[label] = frames
        (la, a), (lb, bb) = got.items()
        same = a.shape == bb.shape and np.array_equal(a, bb)
        check(same, f"VQ stream B={b}: {la} and {lb} pushes differ")
        rel, ties = _vq_stream_check(enc, wav, a, f"VQ stream B={b}")
        print(f"[variants-serve] VQ8192 stream B={b}, {STREAM_SECONDS} s: "
              f"{la} and {lb} pushes bit for bit equal: {same}; streamed "
              f"vs offline max|d|/max|y| {rel:.3e} where the codes agree "
              f"(bound rtol {STREAM_RTOL}, atol {STREAM_ATOL}); codes "
              f"differing at offline ties {ties} of {a.shape[0] * a.shape[2]}")
    wav = torch.from_numpy((rng.randn(1, n) * 0.1).astype(np.float32)).cuda()
    st = StreamingEncoder(enc)
    times = []
    for beg in range(0, n, SR):
        _sync("cuda")
        t0 = time.perf_counter()
        st.push(wav[:, beg:beg + SR])
        _sync("cuda")
        times.append((time.perf_counter() - t0) * 1e3)
    push_ms = statistics.median(times[1:])
    print(f"[variants-serve] VQ8192 1 s pushes at B=1: median "
          f"{push_ms:.3f} ms per push (pushes 2-{len(times)}), real-time "
          f"factor {push_ms / 1e3:.5f}")
    _push_profiles(enc, wav, "VQ8192")

    # export and serve-encode
    tmp = tempfile.mkdtemp(prefix="pase_chip_vq_export_")
    try:
        lengths = write_wavs(tmp)
        npz = save_variables_npz(os.path.join(tmp, "FE_seed0.npz"),
                                 enc.module.state_dict())
        art = os.path.join(tmp, "artifact")
        common = ["--fe_cfg", VQ_CFG, "--fe_ckpt", npz]
        export_s = _cli_seconds(
            ["export", "--device", "cuda", "--out_dir", art, "--chunk_sizes",
             VQ_EXPORT_BUCKETS, "--streaming_chunk", str(EXPORT_CHUNK)]
            + common)
        lst = ["--wav_list", os.path.join(tmp, "list.txt"), "--files_root",
               tmp]
        _cli_seconds(["forward-chunk", "--device", "cuda", "--chunk_size",
                      "64000", "--out_dir", os.path.join(tmp, "fc")]
                     + common + lst)
        reset_launches()                 # the VQ artifact's calls start
        serve_s = _cli_seconds(["serve-encode", "--export_dir", art,
                                "--out_dir", os.path.join(tmp, "se")] + lst)
        paths["vq_export"] = read_launches()     # ... and end here
        pcalls = sum(-(-m // 64000) for m in lengths.values())
        expected = {**{k: 0 for k in paths["vq_export"]},
                    **k1_calls(enc.module, {(1, 64000 // 160): pcalls})}
        check(paths["vq_export"] == expected,
              f"VQ serve-encode launches {paths['vq_export']}")
        worst = 0.0
        for k, m in lengths.items():
            want = np.load(os.path.join(tmp, "fc", f"{k}.npy"))
            got = np.load(os.path.join(tmp, "se", f"{k}.npy"))
            check(got.shape == want.shape == (256, m // 160),
                  f"VQ serve-encode {k}: {got.shape}")
            worst = max(worst, float(np.abs(got - want).max()))
        check(worst <= SERVE_TOL, f"VQ serve-encode vs forward-chunk: "
              f"{worst:.3e}")
        ssrv = serving.ServingStreamingEncoder(art)
        w = (rng.randn(1, 4 * EXPORT_CHUNK) * 0.1).astype(np.float32)
        ys = [ssrv.push(w[:, i:i + EXPORT_CHUNK])
              for i in range(0, w.shape[1], EXPORT_CHUNK)]
        sgot = np.concatenate(ys + [ssrv.flush()], axis=2)
        swant = stream_frames(enc, torch.from_numpy(w).cuda(),
                              EXPORT_CHUNK).cpu().numpy()
        ssame = sgot.shape == swant.shape and np.array_equal(sgot, swant)
        print(f"[variants-serve] VQ8192 export (buckets {VQ_EXPORT_BUCKETS}, "
              f"streaming chunk {EXPORT_CHUNK}) {export_s:.2f} s; "
              f"serve-encode {len(lengths)} requests {serve_s:.3f} s, max|"
              f"serve - forward-chunk| {worst:.3e} (bound {SERVE_TOL}); "
              f"launches {paths['vq_export']} ({pcalls} program calls); "
              f"the streaming artifact bit for bit equal to the in-process "
              f"stream: {ssame}")
        check(ssame, "VQ streaming artifact != in-process stream")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del enc
    torch.cuda.empty_cache()
    return paths


def probe_recipe_flags(script):
    """The probe flags of a recipe script's ``python run_probe.py`` line:
    (task, flags), the flags that name its files ($...) and --out
    dropped."""
    import shlex
    with open(os.path.join(HERE, script)) as f:
        text = f.read().replace("\\\n", " ")
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:2] == ["python", "run_probe.py"]:
            flags = []
            rest = words[3:]
            for flag, value in zip(rest[::2], rest[1::2]):
                if "$" not in value and flag != "--out":
                    flags += [flag, value]
            return words[2], flags
    raise ValueError(f"{script}: no run_probe.py command")


def write_timit_like(root, n_train=TIMIT_TRAIN, n_test=TIMIT_TEST,
                     seconds=TIMIT_SECONDS):
    """The TIMIT-shaped corpus of tests/test_timit_decode.py at a larger
    size: speaker directories, harmonic wavs of three f0 classes, one
    alignment label per 10 ms frame; train.lst / test.lst of ``wav ali``
    lines. Returns the number of utterances."""
    from pase_tpu_torch.data.io import write_wav
    rng = np.random.RandomState(0)
    n = int(seconds * SR)
    for split, count in (("train", n_train), ("test", n_test)):
        lines = []
        for u in range(count):
            spk = f"spk{u % 3}"
            os.makedirs(os.path.join(root, spk), exist_ok=True)
            f0 = [110, 180, 260][u % 3]
            t = np.arange(n)
            sig = sum(np.sin(2 * np.pi * f0 * k * t / SR) / k
                      for k in range(1, 4))
            wav = f"{spk}/{split}_{u}.wav"
            write_wav(os.path.join(root, wav),
                      (sig * 0.2 + rng.randn(n) * 0.01).astype(np.float32))
            ali = wav.replace(".wav", ".ali")
            np.savetxt(os.path.join(root, ali),
                       np.full(n // 160, u % 3, np.int32), fmt="%d")
            lines.append(f"{wav} {ali}\n")
        with open(os.path.join(root, f"{split}.lst"), "w") as f:
            f.writelines(lines)
    return n_train + n_test


def write_fake_decoder(root):
    """A decode_dnn.sh that checks its inputs and writes a scoring file
    (tests/test_timit_decode.py's); returns its folder."""
    scripts = os.path.join(root, "kaldi_scripts")
    os.makedirs(scripts, exist_ok=True)
    path = os.path.join(scripts, "decode_dnn.sh")
    with open(path, "w") as f:
        f.write("#!/bin/bash\n"
                "cfg=$1; out=$2; ark=$3\n"
                "[ -f \"$cfg\" ] || exit 2\n"
                "[ -f \"$ark\" ] || exit 3\n"
                "grep -q '^\\[decoding\\]' \"$cfg\" || exit 4\n"
                "mkdir -p \"$out/scoring_kaldi\"\n"
                "echo '%WER 17.9 [ fake ]' > \"$out/scoring_kaldi/wer_4\"\n")
    os.chmod(path, 0o755)
    return scripts


@contextlib.contextmanager
def _timed(module, name, sink):
    """module.name timed (host clock, synchronized) into sink while
    inside."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        _sync("cuda")
        t0 = time.perf_counter()
        out = real(*a, **k)
        _sync("cuda")
        sink.append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def _probe_run(argv, what, layers, n_utts, paths, path):
    """``python -m pase_tpu_torch.run_probe`` in this process, its launch
    counts reset just before and read just after: the unseeded route of a
    B = 1 call of a few hundred frames (the few-lane kernel) once per QRNN
    layer per utterance encoded, no other kernel. Returns (metrics,
    seconds, seconds in train_mlp_probe)."""
    from pase_tpu_torch import run_probe
    from pase_tpu_torch.probes import tasks, timit_decode
    fit_s = []
    reset_launches()                     # the probe's path starts here
    t0 = time.perf_counter()
    with _timed(tasks, "train_mlp_probe", fit_s), \
            _timed(timit_decode, "train_mlp_probe", fit_s):
        metrics = run_probe.main(argv)
    _sync("cuda")
    wall = time.perf_counter() - t0
    paths[path] = read_launches()        # ... and ends here
    expected = {**{k: 0 for k in paths[path]},
                k1_eval((1, 200, 512)): layers * n_utts}
    print(f"[launches] {what}: {paths[path]} (expected {expected}: "
          f"{layers} QRNN layer(s) x {n_utts} utterances)")
    check(paths[path] == expected, f"{what} launches {paths[path]}")
    bad = {k: v for k, v in metrics.items()
           if isinstance(v, float) and not np.isfinite(v)}
    check(not bad, f"{what}: non-finite metrics {bad}")
    return metrics, wall, sum(fit_s)


def phase_probes(tmp, gate):
    """Phase 19: the downstream probes, the superviser and the transfer
    gate on the card (``gate``: its process's result, ``_gate_join``).
    Returns {path: launch counts}."""
    import torch
    from pase_tpu_torch import train as train_cli
    from pase_tpu_torch import transfer_gate, wf_builder
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.data.io import read_wav
    from pase_tpu_torch.probes.extract import FeatureExtractor
    from pase_tpu_torch.profiling import profile_calls
    os.makedirs(tmp, exist_ok=True)
    paths = {}
    # (a) the gate's speaker corpus at its defaults
    corpus = os.path.join(tmp, "spk")
    t0 = time.perf_counter()
    transfer_gate.build_probe_corpus(corpus)
    lists = {s: [l.split() for l in open(os.path.join(corpus, f"{s}.lst"))]
             for s in ("train", "test")}
    n_utts = sum(len(v) for v in lists.values())
    print(f"[probes] speaker corpus: {len(lists['train'])} train + "
          f"{len(lists['test'])} test utterances of 2 s, "
          f"{len({l for _, l in lists['train']})} speakers, written in "
          f"{time.perf_counter() - t0:.1f} s")
    enc = wf_builder(PASEP_CFG, device="cuda", seed=0)
    layers = len(enc.module.rnn.layers)
    npz = save_variables_npz(os.path.join(tmp, "FE_e0.npz"),
                             enc.module.state_dict())
    del enc

    # (b) extraction card vs CPU, the rate at B=1 and a profile
    gpu = FeatureExtractor(PASEP_CFG, npz, mode="avg_concat", device="cuda")
    cpu = FeatureExtractor(PASEP_CFG, npz, mode="avg_concat", device="cpu")
    wavs = [read_wav(os.path.join(corpus, p))[0]
            for p, _ in lists["train"][:PROBE_CHECK_UTTS]]
    worst, cpu_s = 0.0, 0.0
    for w in wavs:
        g = gpu.extract(w)
        t0 = time.perf_counter()
        c = cpu.extract(w)
        cpu_s += time.perf_counter() - t0
        check(g.shape == c.shape == (200, 2 * gpu.encoder.emb_dim),
              f"extraction shape {g.shape}")
        worst = max(worst, float(np.abs(g - c).max() / np.abs(c).max()))
    del cpu
    check(worst <= ENCODER_REL, f"probe extraction card vs cpu: "
          f"{worst:.3e} > {ENCODER_REL}")
    times = []
    for w in wavs * 4:
        t0 = time.perf_counter()
        gpu.extract(w)                   # returns host numpy: synchronized
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    prof = profile_calls([lambda w=w: gpu.extract(w) for w in wavs], 2)
    print(f"[probes] PASE+ extraction at B=1 (2 s utterances, the 1600-"
          f"sample bucket, avg_concat, {PROBE_CHECK_UTTS} utterances): card"
          f" vs cpu max|dy|/max|y_cpu| {worst:.3e} (bound {ENCODER_REL}); "
          f"card {ms:.3f} ms per utterance (median of {len(times)}), "
          f"{2.0 / (ms / 1e3):.1f} audio-s/s; cpu "
          f"{2.0 * len(wavs) / cpu_s:.1f} audio-s/s")
    print_profile(prof, "PASE+ extraction of one 2 s utterance at B=1")
    del gpu
    torch.cuda.empty_cache()

    # (c) the probe CLI: utt with the MiniVoxCeleb recipe's flags, knn,
    # kfold; frames and timit-full on a TIMIT-shaped corpus
    common = ["--fe_cfg", PASEP_CFG, "--fe_ckpt", npz, "--data_root",
              corpus]
    task, flags = probe_recipe_flags(PROBE_RECIPE)
    check(task == "utt", f"{PROBE_RECIPE}: task {task}")
    m, wall, fit_s = _probe_run(
        [task] + common + ["--train_list", os.path.join(corpus, "train.lst"),
                           "--test_list", os.path.join(corpus, "test.lst")]
        + flags, "probe utt", layers, n_utts, paths, "probe")
    check(0.0 <= m["test_sentence_acc"] <= 1.0, f"utt metrics {m}")
    print(f"[probes] run_probe utt {' '.join(flags)} "
          f"({len({l for _, l in lists['train']})} speakers, "
          f"{n_utts} utterances): {wall:.1f} s in all, the MLP's training "
          f"{fit_s:.1f} s; frame acc {m['test_frame_acc']:.4f}, sentence "
          f"acc {m['test_sentence_acc']:.4f} (seeded random PASE+ weights)")
    m, wall, _ = _probe_run(
        ["knn"] + common + ["--train_list",
                            os.path.join(corpus, "train.lst"),
                            "--test_list", os.path.join(corpus, "test.lst")],
        "probe knn", layers, n_utts, paths, "probe_knn")
    print(f"[probes] run_probe knn: {wall:.1f} s; acc "
          f"{m['knn_test_acc']:.4f}")
    with open(os.path.join(corpus, "all.lst"), "w") as f:
        for s in ("train", "test"):
            f.write(open(os.path.join(corpus, f"{s}.lst")).read())
    m, wall, fit_s = _probe_run(
        ["kfold", "--folds", "3"] + common
        + ["--train_list", os.path.join(corpus, "all.lst")],
        "probe kfold", layers, n_utts, paths, "probe_kfold")
    print(f"[probes] run_probe kfold --folds 3: {wall:.1f} s, training "
          f"{fit_s:.1f} s; sentence acc {m['sentence_acc_mean']:.4f} +- "
          f"{m['sentence_acc_std']:.4f}")
    timit = os.path.join(tmp, "timit")
    n_timit = write_timit_like(timit)
    tl = ["--fe_cfg", PASEP_CFG, "--fe_ckpt", npz, "--data_root", timit,
          "--train_list", os.path.join(timit, "train.lst"), "--test_list",
          os.path.join(timit, "test.lst")]
    m, wall, _ = _probe_run(["frames", "--num_classes", "3"] + tl,
                            "probe frames", layers, n_timit, paths,
                            "probe_frames")
    print(f"[probes] run_probe frames ({n_timit} utterances of "
          f"{TIMIT_SECONDS:g} s, 3 classes): {wall:.1f} s; FER "
          f"{m['test_fer']:.4f}")
    with open(os.path.join(HERE, "cfg", "probes", "decoder.cfg")) as f:
        dec = json.load(f)
    dec["decoding_script_folder"] = write_fake_decoder(tmp)
    dec_cfg = os.path.join(tmp, "decoder.json")
    with open(dec_cfg, "w") as f:
        json.dump(dec, f)
    m, wall, _ = _probe_run(
        ["timit-full", "--mlp_cfg",
         os.path.join(HERE, "cfg", "probes", "MLP_PASE.cfg"), "--dec_cfg",
         dec_cfg, "--out_folder", os.path.join(tmp, "timit_out"),
         "--epochs", "4"] + tl,
        "probe timit-full", layers, n_timit, paths, "probe_timit")
    check(m["decode_rc"] == 0 and m["best_wer"] == 17.9,
          f"timit-full with the fake decoder: {m}")
    print(f"[probes] run_probe timit-full (cfg/probes/MLP_PASE.cfg, 4 "
          f"epochs, the fake decode_dnn.sh): {wall:.1f} s; dev FER "
          f"{m['dev_frame_error']:.4f}, decode rc {m['decode_rc']}, best "
          f"WER {m['best_wer']}")

    # (d) the training CLI's --sup_exec: a knn probe on the card and one on
    # the CPU after each of 2 short epochs
    sup_lists = {}
    for s, n in (("train", 3), ("test", 2)):
        sup_lists[s] = os.path.join(tmp, f"sup_{s}.lst")
        with open(sup_lists[s], "w") as f:
            for p, lab in lists[s]:
                if lab < f"spk{SUP_SPEAKERS:02d}" and int(p[-6:-4]) < n:
                    f.write(f"{p} {lab}\n")
    cmds = os.path.join(tmp, "sup.cmds")
    with open(cmds, "w") as f:
        for dev in ("cuda", "cpu"):
            f.write(f"cd {HERE} && {sys.executable} -m "
                    f"pase_tpu_torch.run_probe knn --fe_cfg $cfg --fe_ckpt "
                    f"$model --train_list {sup_lists['train']} --test_list "
                    f"{sup_lists['test']} --data_root {corpus} --k 3 "
                    f"--device {dev} --out $save_path/knn_{dev}_e$iteration"
                    f".json\n")
    save = os.path.join(tmp, "sup_run")
    reset_launches()                     # the superviser's training starts
    t0 = time.perf_counter()
    tr = train_cli.main(["--synthetic", "--net_cfg", WORKERSP_CFG,
                         "--fe_cfg", PASEP_CFG, "--batch_size",
                         str(SUP_BATCH), "--chunk_size", "16000", "--epoch",
                         "2", "--save_path", save, "--sup_exec", cmds,
                         "--sup_freq", "1"])
    _sync("cuda")
    paths["probe_sup"] = read_launches()     # ... and ends here
    train_s = time.perf_counter() - t0
    done = tr.aux_sup.wait(timeout=600)
    wait_s = time.perf_counter() - t0 - train_s
    steps, evals = 2 * tr.bpe, 2 * tr.cfg["va_bpe"]
    eval_kernel = k1_eval((3 * SUP_BATCH, 16000 // 160, 512))
    expected = {**{k: 0 for k in paths["probe_sup"]},
                "qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps, eval_kernel: layers * evals}
    print(f"[launches] superviser's training: {paths['probe_sup']} "
          f"(expected {expected})")
    check(paths["probe_sup"] == expected,
          f"superviser training launches {paths['probe_sup']}")
    rcs = [rc for _, rc in done]
    check(len(done) == 4 and rcs == [0] * 4, f"superviser children {done}")
    accs = {}
    for dev in ("cuda", "cpu"):
        for e in (0, 1):
            with open(os.path.join(save, "sup_aux",
                                   f"knn_{dev}_e{e}.json")) as f:
                accs[f"{dev} e{e}"] = json.load(f)["knn_test_acc"]
    print(f"[probes] train --sup_exec (2 epochs of {tr.bpe} steps at batch "
          f"{SUP_BATCH} x 16000, {tr.cfg['va_bpe']} eval each): training "
          f"{train_s:.1f} s, then {wait_s:.1f} s waiting for the children; "
          f"{len(done)} children, return codes {rcs}; knn acc "
          + ", ".join(f"{k} {v:.4f}" for k, v in accs.items()))
    check(all(0.0 <= v <= 1.0 for v in accs.values()),
          f"the superviser's knn probes: {accs}")
    del tr
    torch.cuda.empty_cache()

    # (e) the transfer gate, cut to GATE_EPOCHS of the JAX record's epochs
    # (started after phase 13: gate_child)
    for line in gate["lines"]:
        print(line)
    paths["forward_chunk_100s"] = _forward_chunk_long_check(gate["fc_long"])
    rc, gate_s = gate["rc"], gate["seconds"]
    paths["transfer_gate"] = gate["launches"]
    gate = gate["json"]
    with open(os.path.join(HERE, "benchmarks", "transfer_gate_r5.json")) as f:
        ref = json.load(f)
    print(f"[gate] python -m pase_tpu_torch.transfer_gate ({gate['epochs']}"
          f" epochs x {gate['bpe']} steps, batch {gate['batch_size']} x "
          f"{gate['chunk_size']}, {gate['n_speakers']} speakers): "
          f"{gate_s:.1f} s, rc {rc}; pretrained "
          f"{gate['pretrained_final_acc']:.3f}, random "
          f"{gate['random_encoder_acc']:.3f}, mfcc "
          f"{gate['mfcc_baseline_acc']:.3f}; margin_final "
          f"{gate['margin_final']:+.3f}, tail_margins_positive "
          f"{gate['tail_margins_positive']}, ok {gate['ok']} (the JAX "
          f"record benchmarks/transfer_gate_r5.json: pretrained "
          f"{ref['pretrained_final_acc']:.3f}, random "
          f"{ref['random_encoder_acc']:.3f}, mfcc "
          f"{ref['mfcc_baseline_acc']:.3f}, ok {ref['ok']}); curve "
          + ", ".join(f"e{c['epoch']} {c['acc']:.3f}" for c in gate["curve"]))
    check(rc == (0 if gate["ok"] else 1), f"gate rc {rc} vs ok {gate['ok']}")
    check(gate["random_encoder_acc"] < 1.0,
          f"random-init probe at {gate['random_encoder_acc']}")
    check(gate["pretrained_final_acc"] > gate["random_encoder_acc"],
          "pretraining did not improve the probe: "
          f"{gate['pretrained_final_acc']} <= {gate['random_encoder_acc']}")
    check(all(v == 0 for v in paths["transfer_gate"].values()),
          f"the gate's encoder has no QRNN: {paths['transfer_gate']}")
    return paths


def _forward_chunk_long(tmp):
    """Phase 19 (f): a 100 s seeded file (FC_LONG_SAMPLES) through
    ``python -m pase_tpu_torch.util_scripts forward-chunk`` in one window
    (``--chunk_size`` its length, a long export bucket) with seeded PASE+
    weights, K1's launches counted from 0 just before the CLI and read just
    after; its frames against the in-memory encoder's on the same file.
    Returns {'launches', 'seconds', 'rel', 'shape', 'finite', 'layers'}."""
    import torch
    from pase_tpu_torch import util_scripts, wf_builder
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.data.io import read_wav, write_wav
    os.makedirs(tmp, exist_ok=True)
    enc = wf_builder(PASEP_CFG, device="cuda", seed=0)
    npz = save_variables_npz(os.path.join(tmp, "FE_seed0.npz"),
                             enc.module.state_dict())
    path, out = (os.path.join(tmp, n) for n in ("long.wav", "long.npy"))
    write_wav(path, (np.random.RandomState(19).randn(FC_LONG_SAMPLES)
                     * 0.1).astype(np.float32))
    reset_launches()                     # the CLI's path starts here
    t0 = time.perf_counter()
    util_scripts.main(["forward-chunk", "--device", "cuda", "--fe_cfg",
                       PASEP_CFG, "--fe_ckpt", npz, "--in_wav", path,
                       "--out_file", out, "--chunk_size",
                       str(FC_LONG_SAMPLES)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()           # ... and ends here
    got = np.load(out)
    wav, _ = read_wav(path)
    ref = enc(wav[None, None])[0].cpu().numpy()
    return {"launches": launches, "seconds": seconds,
            "rel": float(np.abs(got - ref).max() / np.abs(ref).max()),
            "shape": list(got.shape), "finite": bool(np.isfinite(got).all()),
            "layers": len(enc.module.rnn.layers)}


def _forward_chunk_long_check(res):
    """Phase 19 (f)'s checks: (256, FC_LONG_SAMPLES / 160) finite frames
    within 1e-5 of the in-memory encoder's, K1's unseeded route at
    LONG_SHAPE (the split kernel) once per QRNN layer and nothing else.
    Returns its launches."""
    launches = res["launches"]
    expected = {**{k: 0 for k in launches},
                k1_eval(LONG_SHAPE): res["layers"]}
    print(f"[probes] (f) forward-chunk --chunk_size {FC_LONG_SAMPLES} over a "
          f"{FC_LONG_SAMPLES // SR} s file (the gate's process): "
          f"{res['seconds']:.2f} s incl. encoder build + weight load, frames "
          f"{tuple(res['shape'])}, vs the in-memory encoder "
          f"{res['rel']:.3e}; launches {launches} (expected {expected})")
    check(res["shape"] == [256, FC_LONG_SAMPLES // 160] and res["finite"],
          f"forward-chunk of the 100 s file: {res['shape']}, finite "
          f"{res['finite']}")
    check(res["rel"] <= 1e-5, f"forward-chunk of the 100 s file vs the "
          f"encoder: {res['rel']:.3e}")
    check(launches == expected, f"forward-chunk of the 100 s file launched "
          f"{launches} != {expected}")
    return launches


def gate_child(tmp, out):
    """Phase 19 (e) in a process of its own: ``python -m
    pase_tpu_torch.transfer_gate`` cut to GATE_EPOCHS; its rc, launch
    counts and seconds go to ``out`` (JSON), and then phase 19 (f)'s
    (``_forward_chunk_long``)."""
    import torch
    from pase_tpu_torch import transfer_gate
    reset_launches()                     # the gate's path starts here
    t0 = time.perf_counter()
    rc = transfer_gate.main(["--workdir", os.path.join(tmp, "gate"),
                             "--json", os.path.join(tmp, "gate.json"),
                             "--epochs", str(GATE_EPOCHS), "--bpe",
                             str(GATE_BPE)])
    torch.cuda.synchronize()
    res = {"rc": rc, "launches": read_launches(),  # ... and ends here
           "seconds": time.perf_counter() - t0}
    res["fc_long"] = _forward_chunk_long(os.path.join(tmp, "fc_long"))
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def _gate_start(tmp):
    """The transfer gate's process (``gate_child``), started after phase
    13: it runs beside the phases after it, and the host's and the card's
    share of it does not touch their checks."""
    os.makedirs(tmp, exist_ok=True)
    out = os.path.join(tmp, "gate_result.json")
    return tmp, _background(["--gate", tmp, out],
                            os.path.join(tmp, "gate.log")), out


def _gate_join(started):
    """The gate's result: {'rc', 'launches', 'seconds', 'json' (its
    record), 'lines' (its [transfer] lines)}."""
    tmp, proc, out = started
    text = _background_join(proc, "the gate's process", 900)
    with open(out) as f:
        res = json.load(f)
    with open(os.path.join(tmp, "gate.json")) as f:
        res["json"] = json.load(f)
    res["lines"] = [line for line in text.splitlines()
                    if line.startswith("[transfer]")]
    return res


def counted_child(out_dir, argv):
    """Phase 28's ``python -m MODULE ARGS`` (``argv``) as ``python -m``
    runs it, with its launch counts and TF32 flags written to
    ``out_dir/<pid>.json`` at its start, at each launch (a SIGKILL loses
    none that finished) and at exit (``when``)."""
    import atexit
    import runpy
    sys.path.insert(0, os.getcwd())
    import torch
    from pase_tpu_torch.ops import conv, cuda_qrnn
    path = os.path.join(out_dir, f"{os.getpid()}.json")
    b = torch.backends

    def dump(when):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"argv": argv, "launches": read_launches(), "tf32": {
                "matmul": b.cuda.matmul.allow_tf32,
                "cudnn": b.cudnn.allow_tf32}, "when": when}, f)
        os.replace(tmp, path)

    class Counts(dict):
        def __setitem__(self, key, value):
            super().__setitem__(key, value)
            dump("launch")

    cuda_qrnn.LAUNCHES = Counts(cuda_qrnn.LAUNCHES)
    conv.LAUNCHES = Counts(conv.LAUNCHES)
    dump("start")
    atexit.register(dump, "exit")
    sys.argv = [argv[1]] + argv[2:]
    runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    return 0


def det_ops_child(argv, out):
    """Phase 28's listing, in a process of its own: the rehearsal's
    training command (``argv``, the CLI's flags) under torch's
    deterministic algorithms (warn_only); the ops torch warns it has no
    deterministic implementation of go to ``out`` (JSON)."""
    import re
    import warnings
    import torch
    from pase_tpu_torch import train as train_cli
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train_cli.main(argv)
    ops = sorted({m.group(1) for w in caught for m in [re.match(
        r"(\w+) does not have a deterministic implementation",
        str(w.message))] if m})
    with open(out, "w") as f:
        json.dump(ops, f)
    return 0


def _deterministic_start(tmp):
    """``det_ops_child`` on run A's command cut to one epoch, started once
    run A has exited (beside run B); None before that."""
    import glob
    for path in glob.glob(os.path.join(tmp, "counts", "*.json")):
        with open(path) as f:
            rec = json.load(f)
        if rec["when"] == "exit" and _rehearsal_role(rec["argv"]) == "train_A":
            break
    else:
        return None
    args = list(rec["argv"][2:])
    for flag, value in (("--epoch", "1"),
                        ("--save_path", os.path.join(tmp, "det_ops"))):
        args[args.index(flag) + 1] = value
    out = os.path.join(tmp, "det_ops.json")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--det-ops", json.dumps(args), out], cwd=HERE,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _CHILDREN.append(proc)
    return proc, out


def _deterministic_join(started):
    """The ops ``det_ops_child`` listed."""
    proc, out = started
    text = proc.communicate(timeout=300)[0]
    check(proc.returncode == 0, f"rehearsal: the deterministic epoch "
          f"failed: {text[-3000:]}")
    with open(out) as f:
        return json.load(f)


def _rehearsal_start(tmp):
    """Phase 28's script, started in a session of its own (every process
    it starts is ended with it): a ``python`` first on its PATH runs each
    ``python -m`` CLI through ``counted_child``, anything else as it
    is."""
    for d in ("bin", "counts", "work"):
        os.makedirs(os.path.join(tmp, d), exist_ok=True)
    shim = os.path.join(tmp, "bin", "python")
    with open(shim, "w") as f:
        f.write(f"""#!/bin/sh
if [ "$1" = "-m" ]; then
    exec {sys.executable} {os.path.abspath(__file__)} --counted \
        {os.path.join(tmp, "counts")} "$@"
fi
exec {sys.executable} "$@"
""")
    os.chmod(shim, 0o755)
    env = dict(os.environ, **REHEARSAL_ENV,
               OMP_NUM_THREADS=str(CHILD_THREADS),
               PATH=os.path.join(tmp, "bin") + os.pathsep
               + os.environ.get("PATH", ""))
    with open(os.path.join(tmp, "stdout.log"), "w") as out:
        proc = subprocess.Popen(
            ["bash", os.path.join(HERE, REHEARSAL),
             os.path.join(tmp, "work")], cwd=HERE, env=env, stdout=out,
            stderr=subprocess.STDOUT, start_new_session=True)
    _CHILDREN.append(proc)
    _GROUPS.append(proc.pid)
    state = {"tmp": tmp, "proc": proc, "t0": time.perf_counter(),
             "det": None, "wall": None}
    state["watch"] = threading.Thread(target=_rehearsal_watch, args=(state,),
                                      daemon=True)
    state["watch"].start()
    return state


def _rehearsal_watch(state):
    """A thread of the main process while the script runs: it starts the
    deterministic epoch once run A has exited, ends the script past
    REHEARSAL_TIMEOUT and takes its wall time when it ends."""
    proc = state["proc"]
    while proc.poll() is None:
        if state["det"] is None:
            state["det"] = _deterministic_start(state["tmp"])
        if time.perf_counter() - state["t0"] > REHEARSAL_TIMEOUT:
            _end_group(proc.pid)
            proc.wait()
        time.sleep(1)
    state["wall"] = time.perf_counter() - state["t0"]


def _end_group(pgid):
    import signal
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _rehearsal_role(argv):
    """The rehearsal CLI of a counted process's argv."""
    module, args = argv[1], argv[2:]
    if module == "pase_tpu_torch.train":
        save = os.path.basename(args[args.index("--save_path") + 1])
        return "train_" + save[len("run"):]
    if module == "pase_tpu_torch.util_scripts":
        return args[0]
    if module == "pase_tpu_torch.run_probe":
        return "probe_sup" if "--fe_ckpt" in args else "probe_random"
    return module.split(".")[-1]


def _rehearsal_join(started):
    """Phase 28's result: the script's PASS lines, its steps' seconds,
    the launches and TF32 flags of each CLI. Returns {'rehearsal': the
    launches of every CLI process, summed}."""
    import glob
    from pase_tpu_torch.frontend import wf_builder
    started["watch"].join()
    tmp, proc, det = started["tmp"], started["proc"], started["det"]
    wall = started["wall"]
    check(wall is not None, "rehearsal: its watching thread failed")
    _end_group(proc.pid)            # the probes' shells, if any are left
    with open(os.path.join(tmp, "stdout.log")) as f:
        text = f.read()
    check(wall <= REHEARSAL_TIMEOUT, f"rehearsal: not done in "
          f"{REHEARSAL_TIMEOUT} s: {text[-3000:]}")
    lines = [ln for ln in text.splitlines() if ln.startswith("[rehearsal]")]
    for ln in lines:
        print(ln)
    log = os.path.join(tmp, "work", "rehearsal.log")
    if proc.returncode != 0 and os.path.exists(log):
        with open(log) as f:
            text += "\n--- rehearsal.log ---\n" + f.read()[-4000:]
    check(proc.returncode == 0, f"rehearsal exited {proc.returncode}: "
          f"{text[-5000:]}")
    check(any("REHEARSAL COMPLETE" in ln for ln in lines),
          "rehearsal: no completion line")
    roles, n_tf32 = {}, 0
    for path in sorted(glob.glob(os.path.join(tmp, "counts", "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        role = _rehearsal_role(rec["argv"])
        roles.setdefault(role, []).append(rec)
        if rec["argv"][1] in DEVICE_CLIS:
            # flags read at a launch or at exit, after the CLI's setup
            n_tf32 += 1
            check(rec["when"] != "start" and not (
                rec["tf32"]["matmul"] or rec["tf32"]["cudnn"]),
                f"rehearsal: {role} ran with TF32 on or was read only "
                f"before its setup: {rec['tf32']}, {rec['when']}")
    launches = {role: {k: sum(r["launches"][k] for r in recs)
                       for k in recs[0]["launches"]}
                for role, recs in roles.items()}
    with open(os.path.join(tmp, "work", "runA", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    bpe = next(r["step"] for r in recs if r["split"] == "perf")
    epochs = int(REHEARSAL_ENV["EPOCHS"])
    layers = len(wf_builder(PASEP_CFG, device="cpu").module.rnn.layers)
    zero = {k: 0 for k in launches["train_A"]}
    want = {
        "train_A": {**zero, "qrnn_pool_fwd_train": layers * epochs * bpe,
                    "qrnn_pool_bwd": layers * epochs * bpe,
                    k1_eval(TRAIN_SHAPE): layers * epochs * max(bpe // 10,
                                                                 1)},
        "forward-chunk": {**zero, k1_eval((1, 800, 512)): layers},
        "serve-encode": {**zero, k1_eval((1, 800, 512)): layers}}
    if "train_A2" in launches:      # the card's spread: A2 is run as A
        want["train_A2"] = want["train_A"]
    print(f"[rehearsal] phase 28: bash {REHEARSAL} with "
          + " ".join(f"{k}={v}" for k, v in REHEARSAL_ENV.items())
          + f" ({REHEARSAL_ENV.get('BATCH', 32)} x "
          f"{REHEARSAL_ENV.get('CHUNK', 32000)} float32, {bpe} steps an "
          f"epoch): every assertion "
          f"passed in {wall:.1f} s; TF32 off after the setup of each of the "
          f"{n_tf32} --device CLI processes")
    for role in sorted(launches):
        print(f"[launches] rehearsal {role} ({len(roles[role])} "
              f"process(es)): {launches[role]}")
    for role, w in want.items():
        check(launches.get(role) == w, f"rehearsal {role} launches "
              f"{launches.get(role)} != {w}")
    # run B: the killed process past epoch 1's last step and its two
    # evals, the resumed one from epoch 2's first step to the end
    va = max(bpe // 10, 1)
    killed, resumed = (next(r["launches"] for r in roles["train_B"]
                            if (r["when"] == "exit") == done)
                       for done in (False, True))
    check(len(roles["train_B"]) == 2, "rehearsal: run B is not two "
          "processes")
    check(resumed == {**zero,
                      k1_eval(TRAIN_SHAPE): layers * (epochs - 2) * va,
                      "qrnn_pool_fwd_train": layers * (epochs - 2) * bpe,
                      "qrnn_pool_bwd": layers * (epochs - 2) * bpe},
          f"rehearsal: the resumed run B launched {resumed}")
    check(killed[k1_eval(TRAIN_SHAPE)] == layers * 2 * va
          and 2 * bpe * layers < killed["qrnn_pool_fwd_train"]
          <= epochs * bpe * layers, f"rehearsal: the killed run B launched "
          f"{killed}, not 2 evals and a step of epoch 2")
    with open(os.path.join(tmp, "work", "probe_tr.lst")) as f:
        utts = sum(1 for line in f if line.strip())
    with open(os.path.join(tmp, "work", "probe_te.lst")) as f:
        utts += sum(1 for line in f if line.strip())
    for role in ("probe_sup", "probe_random"):
        for r in roles[role]:
            check(r["launches"] == {**zero, k1_eval((1, 200, 512)):
                                    layers * utts},
                  f"rehearsal {role} launched {r['launches']}, not "
                  f"{layers} x {utts} utterances of "
                  f"{k1_eval((1, 200, 512))}")
    # the ops torch cannot make repeat: where B is held to the spread, they
    # and cuDNN's algorithm choice are what the bits may differ by
    ops = _deterministic_join(det or _deterministic_start(tmp))
    print(f"[rehearsal] run A's command for an epoch under torch's "
          f"deterministic algorithms (beside run B, a process of its own): "
          f"ops without a deterministic implementation: "
          f"{', '.join(ops) or 'none'}")
    total = {k: sum(c[k] for c in launches.values()) for k in zero}
    return {"rehearsal": total}


def _pool_inputs(enc, wav):
    """The QRNN pooling inputs y (one a layer) of ``enc``'s forward on
    ``wav``, as the layers pass them to cuda_qrnn.qrnn_pool."""
    import torch
    from pase_tpu_torch.ops import cuda_qrnn
    seen, inner = [], cuda_qrnn.qrnn_pool

    def record(y, c0=None):
        seen.append(y.clone())
        return inner(y, c0)
    cuda_qrnn.qrnn_pool = record
    try:
        with torch.no_grad():
            enc(wav)
    finally:
        cuda_qrnn.qrnn_pool = inner
    return seen


def phase_trained_gates(run_dir):
    """A trained encoder's gates (phase 28's run A, its last FE_e*.npz; the
    card otherwise idle): the first QRNN layer's pooling input y of a
    seeded wav of each of TRAINED_GATE_SECONDS; the few-lane kernel and
    the split kernel on it in turns (CUDA graphs), each within KERNEL_ATOL
    of the
    plain version; the split kernel's share of segments run again
    (kernel_variants.rerun_share) and the gates' a = 1 - f. Returns
    {shape: its numbers}."""
    import glob
    import numpy as np
    import torch
    from pase_tpu_torch.frontend import wf_builder
    from pase_tpu_torch.kernel_variants import rerun_share
    from pase_tpu_torch.ops import cuda_qrnn
    from pase_tpu_torch.ops import qrnn as plain
    ckpts = glob.glob(os.path.join(run_dir, "FE_e*.npz"))
    check(bool(ckpts), f"no FE_e*.npz in {run_dir}")
    npz = max(ckpts, key=lambda p: int(p.rsplit("FE_e", 1)[1][:-4]))
    enc = wf_builder(PASEP_CFG, device="cuda").load_pretrained(npz)
    out = {}
    for seconds in TRAINED_GATE_SECONDS:
        wav = (np.random.RandomState(seconds).randn(1, 1, seconds * SR)
               * 0.1).astype(np.float32)
        y = _pool_inputs(enc, wav)[0]
        b, t, h3 = y.shape
        h_ref, c_ref = plain.qrnn_pool(y)
        errs = {}
        for name, fn in (
                ("few", lambda: cuda_qrnn.qrnn_pool_fwd_few(y)),
                ("split", lambda: cuda_qrnn.qrnn_pool_fwd_split(y))):
            hk, ck = fn()
            errs[name] = max((hk - h_ref).abs().max().item(),
                             (ck - c_ref).abs().max().item())
            check(errs[name] <= KERNEL_ATOL, f"{name} on the trained gates "
                  f"at {list(y.shape)}: {errs[name]:.3e} > {KERNEL_ATOL}")
        ms = _turns_ms({
            "few": lambda: _graph_ms(lambda: cuda_qrnn.qrnn_pool_fwd_few(y)),
            "split": lambda: _graph_ms(
                lambda: cuda_qrnn.qrnn_pool_fwd_split(y))})
        a = 1.0 - torch.sigmoid(y[..., h3 // 3:2 * h3 // 3]).flatten()
        q = torch.quantile(a[torch.randperm(a.numel(), device=a.device)[
            :1 << 20]], torch.tensor([0.5, 0.99, 0.999], device=a.device))
        share = rerun_share(y)
        route = k1_eval((b, t, h3 // 3))
        print(f"[trained] {os.path.basename(npz)} of run A on a {seconds} s "
              f"seeded wav: the first QRNN layer's y[{b},{t},{h3}]; a = 1 - "
              f"f median {q[0].item():.4f}, 99th percentile "
              f"{q[1].item():.4f}, 99.9th {q[2].item():.4f}; in turns: few "
              f"{ms['few']:.5f} ms, split {ms['split']:.5f} ms; max err vs "
              f"plain "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; the split kernel's segments run again {share:.1%}; "
              f"routed to {route}")
        out["x".join(map(str, (b, t, h3 // 3)))] = {
            "ms": ms, "err": errs, "rerun_share": share, "route": route,
            "a_quantiles": [v.item() for v in q]}
        del y, h_ref, c_ref
    del enc
    torch.cuda.empty_cache()
    return out


def _rnn_encoder_cfg(tmp, rnn_type):
    """PASE+.cfg with an lstm / gru context layer, written to ``tmp``."""
    with open(PASEP_CFG) as f:
        cfg = json.load(f)
    path = os.path.join(tmp, f"PASE+_{rnn_type}.cfg")
    with open(path, "w") as f:
        json.dump(dict(cfg, rnn_type=rnn_type), f)
    return path


def _timed_steps(tr, batches, warm=1):
    """(steps/s of ``tr.train_step`` over batches[warm:] after the first
    ``warm`` steps, the last step's losses); every loss finite."""
    import math
    import torch
    for raw in batches[:warm]:
        tr.train_step(raw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [tr.train_step(raw) for raw in batches[warm:]]
    torch.cuda.synchronize()
    rate = (len(batches) - warm) / (time.perf_counter() - t0)
    bad = [(k, float(v)) for ls in losses for k, v in ls.items()
           if not math.isfinite(float(v))]
    check(not bad, f"non-finite losses {bad[:5]}")
    return rate, losses[-1]


def _busy_split(kinds):
    """Device ms per step by kind ({kind: ms}) as cuDNN's recurrent
    kernels, GEMMs, convolutions and the rest."""
    out = {"rnn": 0.0, "matmul": 0.0, "conv": 0.0, "rest": 0.0}
    for kind, ms in kinds.items():
        key = ("conv" if kind.startswith("conv") else
               kind if kind in ("rnn", "matmul") else "rest")
        out[key] += ms
    return out


def _wavernn_card_vs_cpu(mode):
    """The WaveRNN head at the cfg's widths, train mode, on the card and
    on the CPU from the same weights and inputs: the logits within
    WAVERNN_LOGIT_REL of their largest, the loss within 1e-4, and the
    gradients under the CPU loss's cotangent (MoL's branch at cdf_delta =
    1e-5 is a kink) by phase 7's rule: relu inputs of opposite sign only
    within FLIP_REL of their module's largest from 0, and the CPU's relus
    on the card's side of their kink. Returns the card's head."""
    import torch
    from pase_tpu_torch.grad_parity import (group_errors, prelu_signs,
                                            sign_flips, worst_leaves)
    from pase_tpu_torch.wavernn import (WaveRNNMinion,
                                        discretized_mix_logistic_loss,
                                        raw_loss)
    b, t = WAVERNN_CHECK
    rng = np.random.RandomState(12)
    mels = torch.from_numpy(rng.randn(b, 256, t // 160 + 4)
                            .astype(np.float32))
    wav = torch.from_numpy(np.clip(rng.randn(b, t) * 0.3, -1, 1)
                           .astype(np.float32))
    x_prev = torch.nn.functional.pad(wav, (1, 0))[:, :-1]
    cpu = WaveRNNMinion(256, mode=mode, generator=torch.Generator()
                        .manual_seed(13), **WAVERNN_HEAD).train()
    gpu = WaveRNNMinion(256, mode=mode, **WAVERNN_HEAD).cuda().train()
    gpu.load_state_dict(cpu.state_dict())

    def loss_of(y, target):
        return (raw_loss(y, target, bits=WAVERNN_HEAD["bits"])
                if mode == "RAW" else discretized_mix_logistic_loss(y, target))

    x_gpu, x_cpu = {}, {}
    t0 = time.perf_counter()
    with prelu_signs(gpu, record=x_gpu):
        yg = gpu(x_prev.cuda(), mels.cuda())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    with prelu_signs(cpu, record=x_cpu,
                     force={k: x > 0 for k, x in x_gpu.items()}):
        yc = cpu(x_prev, mels)
    lc = yc.detach().requires_grad_()
    loss_c = loss_of(lc, wav)
    loss_c.backward()
    yc.backward(lc.grad)
    yg.backward(lc.grad.cuda())
    flips = sign_flips(x_gpu, x_cpu)
    far = max([r for _, r in flips.values()], default=0.0)
    loss_g = loss_of(yg.detach(), wav.cuda()).item()
    rel_y = ((yg.detach().cpu() - yc.detach()).abs().max()
             / yc.abs().max()).item()
    rel_l = abs(loss_g - loss_c.item()) / abs(loss_c.item())
    gg = {f"w.{k}": p.grad.cpu() for k, p in gpu.named_parameters()}
    gc = {f"w.{k}": p.grad for k, p in cpu.named_parameters()}
    grad_err = group_errors(gg, gc)["minion"]
    worst = worst_leaves(gg, gc, n=3)
    print(f"[recurrent] WaveRNN head {mode} (256 in, rnn 512, fc 512, "
          f"{gpu.n_classes} outputs), batch {b} x {t}, train mode, card "
          f"vs cpu: max|dy| / max|y| {rel_y:.2e} (bound "
          f"{WAVERNN_LOGIT_REL}); loss {loss_g:.6f} vs {loss_c.item():.6f}"
          f" ({rel_l:.2e}, bound {TRAIN_LOSS_REL}); relu inputs of "
          f"opposite sign {sum(n for n, _ in flips.values())}, the largest "
          f"|x| {far:.2e} of its module's max (bound {FLIP_REL}); "
          f"gradients under the cpu's cotangent, its relus on the card's "
          f"side: max|dg| / max|g| {grad_err:.2e} (bound "
          f"{TRAIN_GRAD_REL}); worst leaves: " + "; ".join(
              f"{k[2:]} {a:.2e}" for k, a, _, _ in worst)
          + f"; the card's forward {ms:.1f} ms (first call)")
    check(far <= FLIP_REL, f"WaveRNN {mode}: a relu input {far:.3e} of "
          f"its module's max from 0 has opposite signs: {flips}")
    check(rel_y <= WAVERNN_LOGIT_REL, f"WaveRNN {mode} logits {rel_y:.3e}")
    check(rel_l <= TRAIN_LOSS_REL, f"WaveRNN {mode} loss {rel_l:.3e}")
    check(grad_err <= TRAIN_GRAD_REL, f"WaveRNN {mode} gradients "
          f"{grad_err:.3e}")
    check(all(a <= TRAIN_GRAD_REL for _, a, _, _ in worst),
          f"WaveRNN {mode} gradient leaves {worst}")
    check(all(gpu.upsample.get_parameter(f"up_{i}_kernel").grad.abs().max()
              > 0 for i in range(3)), "no gradient reached up_i_kernel")
    return gpu


def _rnn_encoders(tmp, raw):
    """Phase 20 (a): PASE+ with an lstm / gru context layer: serving card
    vs cpu, an exported bucket against the offline encoder, the lstm
    encoder's step card vs cpu and its rate at RNN_STEP_SHAPE."""
    import torch
    from pase_tpu_torch import serving
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.trainer import Trainer
    paths = {}
    for rt in ("lstm", "gru"):
        cfg = _rnn_encoder_cfg(tmp, rt)
        reset_launches()                 # this encoder's path starts
        enc, _ = phase_encoder("cuda", cfg=cfg, reps=3)
        launches = read_launches()       # ... and ends here
        print(f"[recurrent] PASE+ {rt} (BiRNN 2 x 256): launches "
              f"{launches}")
        check(all(v == 0 for v in launches.values()),
              f"{rt} encoder launched a QRNN kernel: {launches}")
        paths[f"{rt}_serving"] = launches
        out = os.path.join(tmp, f"art_{rt}")
        t0 = time.perf_counter()
        serving.export_encoder(enc, out, chunk_sizes=(EXPORT_CHUNK,))
        export_s = time.perf_counter() - t0
        wav = (np.random.RandomState(14).randn(EXPORT_CHUNK) * 0.1).astype(
            np.float32)
        got = serving.ServingEncoder(out).encode(wav)
        want = enc(wav[None, None])[0].cpu().numpy()
        err = float(np.abs(got - want).max())
        print(f"[recurrent] PASE+ {rt}: export of the {EXPORT_CHUNK} "
              f"bucket {export_s:.2f} s; serve-encode of a 1 s wav against "
              f"the offline encoder max|dy| {err:.2e} (bound {SERVE_TOL})")
        check(err <= SERVE_TOL, f"{rt} artifact vs offline {err:.3e}")
        del enc
    cfg = _rnn_encoder_cfg(tmp, "lstm")
    paths["lstm_step"] = _variant_step(
        cfg, WORKERSP_CFG, raw, "PASE+ lstm + workers+",
        os.path.join(tmp, "lstm_step"))
    b, t = RNN_STEP_SHAPE
    tr = Trainer(cfg, WORKERSP_CFG, dict(
        backprop_mode="base", hop=160, bpe=100, epoch=1, batch_size=b,
        chunk_size=t, save_path=os.path.join(tmp, "lstm_rate")),
        device="cuda")
    batcher = DeviceSyntheticBatcher(b, t, seed=11)
    rate, _ = _timed_steps(tr, [batcher.make_batch() for _ in range(4)])
    print(f"[recurrent] PASE+ lstm + workers+ train step at {b} x {t}, "
          f"float32: {rate:.3f} steps/s (3 steps after 1), every loss "
          "finite")
    del tr
    torch.cuda.empty_cache()
    return paths


def _gru_head_step(tmp, raw):
    """Phase 20 (b): workers+ with its prosody head a GRU head (r 1: one
    frame out), a full-width step card vs cpu."""
    from pase_tpu_torch.model import parse_workers_cfg
    workers = parse_workers_cfg(WORKERSP_CFG)
    for e in workers["regr"]:
        if e["name"] == "prosody":
            e.update(type="gru", hidden_size=256, hidden_layers=2)
            e.pop("r", None)
    return {"gru_head_step": _variant_step(
        PASEP_CFG, workers, raw, "PASE+ workers+, prosody a GRU head",
        os.path.join(tmp, "gru_head_step"))}


def _wavernn_recipe_step(tmp):
    """Phase 20 (d): the WaveRNN recipe's step at its own shape in this
    process (its flags through the CLI's parser), against the same
    settings with workers+: steps/s, a profiled step's busy split, idle
    share, peak memory, the training kernels once each per step."""
    import torch
    from pase_tpu_torch import train as train_cli
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.profiling import profile_calls
    from pase_tpu_torch.trainer import Trainer
    paths, rates, profs, peaks = {}, {}, {}, {}
    for label, net in (("workers+wavernn", WAVERNN_CFG),
                       ("workers+", WORKERSP_CFG)):
        run = os.path.join(tmp, "rate_" + label)
        opts = train_cli.build_argparser().parse_args(
            _recipe_cli_argv(run, script=WAVERNN_RECIPE,
                             values={"--net_cfg": net}))
        cfg = dict(vars(opts), bpe=100, va_bpe=10,
                   random_scale=train_cli.str2bool(opts.random_scale))
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(opts.fe_cfg, opts.net_cfg, cfg, device="cuda")
        batcher = DeviceSyntheticBatcher(tr.batch_size, tr.chunk_size,
                                         seed=15)
        reset_launches()                 # the recipe's steps start here
        rates[label], last = _timed_steps(
            tr, [batcher.make_batch() for _ in range(4)])
        launches = read_launches()       # ... and end here
        peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = {**{k: 0 for k in launches},
                    "qrnn_pool_fwd_train": 4, "qrnn_pool_bwd": 4}
        check(launches == expected, f"{label} step launches {launches}")
        if net == WAVERNN_CFG:
            paths["wavernn_step"] = launches
            check("wavernn" in last, "the recipe ran without its worker")
            print(f"[recurrent] the recipe's step: wavernn loss "
                  f"{float(last['wavernn']):.4f} (log 512 = "
                  f"{np.log(512):.4f}), total {float(last['total']):.4f}")
        raw = batcher.make_batch()
        # the card's activity alone: per-op host events for a step of
        # 325k kernels take minutes to read
        profs[label] = profile_calls([lambda: tr.train_step(raw)],
                                     warmup=0, spans=False)
        del tr
        torch.cuda.empty_cache()
    split = {k: _busy_split(p["split"]["all"]) for k, p in profs.items()}
    w, p = "workers+wavernn", "workers+"
    # the profiled step's wall is longer than an unprofiled one (the
    # profiler records every kernel): the idle share of the unprofiled
    # step takes the covered time over the timed steps' wall
    idle = {k: max(0.0, 1.0 - profs[k]["covered_ms"] * rates[k] / 1e3)
            for k in profs}
    print(f"[recurrent] the WaveRNN recipe (batch 16 x 32000, bf16): "
          f"{rates[w]:.4f} steps/s, the same settings with workers+ "
          f"{rates[p]:.3f} ({rates[w] / rates[p]:.4f}x); device busy ms "
          f"per step: kernel time {profs[w]['busy_ms']:.2f} (cuDNN RNN "
          f"{split[w]['rnn']:.2f}, GEMM {split[w]['matmul']:.2f}, conv "
          f"{split[w]['conv']:.2f}, rest {split[w]['rest']:.2f}) against "
          f"{profs[p]['busy_ms']:.2f}, covered by a kernel "
          f"{profs[w]['covered_ms']:.2f} / {profs[p]['covered_ms']:.2f}; "
          f"wall {profs[w]['wall_ms']:.1f} / "
          f"{profs[p]['wall_ms']:.1f} ms profiled, {1e3 / rates[w]:.1f} / "
          f"{1e3 / rates[p]:.1f} unprofiled; idle share 1 - covered / "
          f"wall {idle[w]:.3f} / {idle[p]:.3f} (of the profiled wall "
          f"{profs[w]['idle_share']:.3f} / {profs[p]['idle_share']:.3f}); "
          f"kernels per step {profs[w]['launches']['all']:.0f} / "
          f"{profs[p]['launches']['all']:.0f} (one profiled step each); peak "
          f"memory "
          f"{peaks[w]:.2f} / {peaks[p]:.2f} GiB")
    check(split[w]["rnn"] > 0, "no cuDNN RNN time in the recipe's step")
    return paths


def _wavernn_cli(tmp):
    """Phase 20 (e): the recipe's CLI for one epoch, its chunk cut to
    WAVERNN_CLI_CHUNK so that the epoch fits the run."""
    import torch
    check((48, WAVERNN_CLI_CHUNK // 160, 512) in TRAIN_QRNN_SHAPES,
          "phase 3 does not check K2 at the cut CLI's shape")
    run = os.path.join(tmp, "cli_wavernn")
    torch.cuda.reset_peak_memory_stats()
    tr, launches, _, last = _cli_run(
        _recipe_cli_argv(run, script=WAVERNN_RECIPE, values={
            "--chunk_size": str(WAVERNN_CLI_CHUNK)}),
        f"the WaveRNN recipe, chunk cut to {WAVERNN_CLI_CHUNK}", run,
        (48, WAVERNN_CLI_CHUNK // 160, 512))
    check("wavernn" in last, "the recipe's CLI logged no wavernn loss")
    print(f"[recurrent] the recipe's CLI: step {last['step']} wavernn "
          f"{last['wavernn']:.4f}")
    del tr
    torch.cuda.empty_cache()
    return {"wavernn_cli": launches}


def _wavernn_generate(head):
    """Phase 20 (f): generate RAW with the card's head at GENERATE_SHAPE:
    us per sample, and the teacher-forced forward on its own samples
    against its loop's logits."""
    import torch
    from pase_tpu_torch.wavernn import generate
    b, frames = GENERATE_SHAPE
    mels = torch.from_numpy(np.random.RandomState(16).randn(
        b, 256, frames + 4).astype(np.float32)).cuda()
    reset_launches()                     # generate's path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav, fed, logits = generate(
        head, mels, torch.Generator(device="cuda").manual_seed(17),
        return_logits=True)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 1e6 / wav.shape[1]
    launches = read_launches()           # ... and ends here
    x_prev = torch.nn.functional.pad(fed, (1, 0))[:, :-1]
    with torch.no_grad():
        tf = head.eval()(x_prev, mels)
    rel = ((tf - logits).abs().max() / logits.abs().max()).item()
    print(f"[recurrent] generate RAW, batch {b} x {wav.shape[1]} samples: "
          f"{us:.1f} us per sample (one Python-launched step each); the "
          f"teacher-forced forward on its samples against its loop's "
          f"logits {rel:.2e} of max|logits| (bound {WAVERNN_LOGIT_REL}); "
          f"|wav| <= {wav.abs().max().item():.4f}")
    check(rel <= WAVERNN_LOGIT_REL, f"generate vs teacher forcing {rel}")
    check(wav.abs().max().item() <= 1 + 1e-5, "generate out of [-1, 1]")
    check(all(v == 0 for v in launches.values()),
          f"generate launched a QRNN kernel {launches}")
    return {"wavernn_generate": launches}


def phase_recurrent(tmp):
    """Phase 20: the recurrent layers on the card (cuDNN's LSTM / GRU):
    the lstm / gru encoders, a GRU head, the WaveRNN worker and its
    recipe, and generate. Returns {path: launch counts}."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=10)))
    paths = _rnn_encoders(tmp, raw)
    paths.update(_gru_head_step(tmp, raw))
    heads = {mode: _wavernn_card_vs_cpu(mode) for mode in ("RAW", "MOL")}
    paths.update(_wavernn_recipe_step(tmp))
    paths.update(_wavernn_cli(tmp))
    paths.update(_wavernn_generate(heads["RAW"]))
    print(f"[recurrent] phase 20 in {time.perf_counter() - t0:.1f} s")
    return paths


def _tdnn_serving():
    """Phase 21 (a): TDNNFe at cfg/frontend/TDNN.cfg, seeded weights,
    float32, through phase 4's checks; K1's unseeded route (the few-lane
    kernel at [8,1000,256]) once per call and no other kernel. Returns
    (encoder, launch counts)."""
    check(TDNN_SERVING_SHAPE in QRNN_SHAPES,
          "phase 3 does not check K1 at the TDNN serving shape")
    reset_launches()                     # the TDNN serving path starts
    enc, calls = phase_encoder("cuda", cfg=TDNN_CFG, label="TDNN")
    launches = read_launches()           # ... and ends here
    layers = qrnn_layers(enc.module)
    expected = {**{k: 0 for k in launches}, **k1_calls(enc.module, calls)}
    print(f"[launches] TDNN serving: {launches} (expected {expected}: "
          f"{layers} QRNN layer(s) x {sum(calls.values())} encoder calls)")
    check(layers == 1 and launches == expected,
          f"TDNN serving launches {launches}")
    return enc, launches


def _tdnn_export(enc, tmp):
    """Phase 21 (d): ``util_scripts export`` of the TDNN encoder on the
    card (halo null: every request takes the largest bucket), serve-encode
    over phase 5's four wavs against forward-chunk --chunk_size 64000, and
    the streaming export's refusal. Returns serve-encode's launches."""
    from pase_tpu_torch import serving
    from pase_tpu_torch.checkpoint import save_variables_npz
    root = os.path.join(tmp, "tdnn_export")
    os.makedirs(root, exist_ok=True)
    lengths = write_wavs(root)
    npz = save_variables_npz(os.path.join(root, "FE_seed0.npz"),
                             enc.module.state_dict())
    art = os.path.join(root, "artifact")
    common = ["--fe_cfg", TDNN_CFG, "--fe_ckpt", npz]
    export_s = _cli_seconds(["export", "--device", "cuda", "--out_dir", art,
                             "--chunk_sizes", EXPORT_BUCKETS] + common)
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    check(meta["halo"] is None and meta["hop"] == 160
          and meta["device"] == "cuda", f"TDNN artifact meta {meta}")
    try:
        serving.export_streaming_encoder(enc, os.path.join(root, "stream"),
                                         chunk=EXPORT_CHUNK)
        refused = None
    except TypeError as e:
        refused = str(e)
    check(refused is not None, "the TDNN stream was not refused")
    lst = ["--wav_list", os.path.join(root, "list.txt"), "--files_root",
           root]
    fc_s = _cli_seconds(["forward-chunk", "--device", "cuda", "--chunk_size",
                         "64000", "--out_dir", os.path.join(root, "fc")]
                        + common + lst)
    reset_launches()                     # the served programs start here
    se_s = _cli_seconds(["serve-encode", "--export_dir", art, "--out_dir",
                         os.path.join(root, "se")] + lst)
    launches = read_launches()           # ... and end here
    calls = sum(-(-m // 64000) for m in lengths.values())
    expected = {**{k: 0 for k in launches},
                **k1_calls(enc.module, {(1, 64000 // 160): calls})}
    worst = 0.0
    for k, m in lengths.items():
        want = np.load(os.path.join(root, "fc", f"{k}.npy"))
        got = np.load(os.path.join(root, "se", f"{k}.npy"))
        check(got.shape == want.shape == (enc.emb_dim, m // 160),
              f"TDNN serve-encode {k}: {got.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"[encoders] TDNN export (buckets {EXPORT_BUCKETS}, traced on the "
          f"card) {export_s:.2f} s: halo {meta['halo']}, hop {meta['hop']}; "
          f"the streaming export refused: {refused!r}; serve-encode of "
          f"{len(lengths)} wavs {se_s:.3f} s against forward-chunk "
          f"--chunk_size 64000 {fc_s:.3f} s: max|d| {worst:.3e} (bound "
          f"{SERVE_TOL})")
    print(f"[launches] TDNN serve-encode: {launches} (expected {expected}: "
          f"{calls} program calls at the largest bucket)")
    check(worst <= SERVE_TOL, f"TDNN serve-encode vs forward-chunk {worst}")
    check(launches == expected, f"TDNN serve-encode launches {launches}")
    return launches


def _tdnn_recipe(tmp, bf16_rate):
    """Phase 21 (c): recipes/run_pase_tdnn.sh through the CLI with
    --synthetic for one epoch at its batch and chunk (64 x 32000, bf16):
    steps/s beside phase 8's PASE+ bf16 rate, one profiled step's kernel
    time by kind and idle share, peak memory. The recipe's
    cfg/distortions/pase+.cfg names corpora that are not in the
    repository: bench.py's stack on its seeded assets stands in (its
    reverb .5, overlap .1, noise .4, clip .2 and chop .2 are pase+.cfg's;
    the filter stages, downsample .25 and bandrop .35, are off)."""
    import torch
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.profiling import profile_calls
    check(TDNN_TRAIN_SHAPE in TRAIN_QRNN_SHAPES
          and TDNN_TRAIN_SHAPE in QRNN_SHAPES,
          "phase 3 does not check K1 / K2 at the TDNN recipe's shape")
    run = os.path.join(tmp, "tdnn_cli")
    torch.cuda.reset_peak_memory_stats()
    dist = write_bench_dtrans_cfg(os.path.join(tmp, "tdnn_assets"))
    tr, launches, perf, last = _cli_run(
        _recipe_cli_argv(run, script=TDNN_RECIPE) + ["--dtrans_cfg", dist],
        "the TDNN recipe", run, TDNN_TRAIN_SHAPE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(tr.cfg["compute_dtype"] == "bfloat16"
          and (tr.batch_size, tr.chunk_size) == (64, 32000),
          f"the TDNN recipe's flags: {tr.cfg}")
    rate = perf["steps_per_sec"]
    raw = DeviceSyntheticBatcher(tr.batch_size, tr.chunk_size,
                                 seed=19).make_batch()
    prof = profile_calls([lambda: tr.train_step(raw)] * 2, warmup=1,
                         spans=False)
    kinds = prof["split"]["all"]
    split = _busy_split(kinds)
    idle = max(0.0, 1.0 - prof["covered_ms"] * rate / 1e3)
    print(f"[encoders] the TDNN recipe (TDNN.cfg + workers+, batch 64 x "
          f"32000, bf16, the bench stack): {rate:.3f} steps/s, "
          f"{perf['audio_sec_per_sec']:.1f} audio-s/s, against phase 8's "
          f"PASE+ bf16 bench step {bf16_rate:.3f} ({rate / bf16_rate:.3f}x);"
          f" one profiled step: device busy {prof['busy_ms']:.2f} ms (GEMM "
          f"{split['matmul']:.2f}, conv {split['conv']:.2f}, rest "
          f"{split['rest']:.2f}; by kind: " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(kinds.items(),
                                                key=lambda kv: -kv[1]))
          + f"), covered {prof['covered_ms']:.2f} ms, wall "
          f"{prof['wall_ms']:.1f} ms profiled, {1e3 / rate:.1f} unprofiled;"
          f" idle share 1 - covered / wall {idle:.3f} (of the profiled wall"
          f" {prof['idle_share']:.3f}); kernels per step "
          f"{prof['launches']['all']:.0f}; peak memory {peak:.2f} GiB; "
          f"last step total {last['total']:.4f}")
    del tr
    torch.cuda.empty_cache()
    return {"tdnn_cli": launches}


def _alt_encoders():
    """Phase 21 (e): ASPPResEncoder (without and with its QRNN) and
    ResnetEncoder at the JAX modules' defaults, seeded weights, through
    phase 4's checks at ALT_SHAPE (T / hop frames: the ResNet's hop is
    40); K1's unseeded route (the few-lane kernel at [8,200,256]) once per
    call where there is a QRNN. Returns {path: launch counts}."""
    import torch
    paths = {}
    b, t = ALT_SHAPE
    for label, cfg in ALT_ENCODERS.items():
        reset_launches()                 # this encoder's path starts
        enc, calls = phase_encoder("cuda", cfg=cfg, batch=b, samples=t,
                                   reps=3, label=label)
        launches = read_launches()       # ... and ends here
        layers = qrnn_layers(enc.module)
        expected = {**{k: 0 for k in launches},
                    **k1_calls(enc.module, calls)}
        print(f"[launches] {label}: {launches} (expected {expected}: "
              f"{layers} QRNN layer(s) x {sum(calls.values())} encoder "
              f"calls); hop "
              f"{enc.module.hop}")
        check(label != "resnet" or enc.module.hop == 40,
              f"the ResNet's hop {enc.module.hop}")
        check(launches == expected and layers == (label == "aspp_rnn"),
              f"{label} launches {launches}")
        paths[f"{label}_serving"] = launches
        del enc
        torch.cuda.empty_cache()
    return paths


def _dropout_off(tr):
    """The ASPP dropout of a trainer's encoder at rate 0 (card and CPU
    cannot draw the same masks)."""
    from pase_tpu_torch.encoders import ASPP
    for m in tr.model.frontend.modules():
        if isinstance(m, ASPP):
            m.dropout = 0.0


def phase_encoders(tmp, bf16_rate):
    """Phase 21: the alternative encoders of pase_tpu_torch/encoders.py on
    the card. Returns {path: launch counts}."""
    import torch
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    paths = {}
    enc, paths["tdnn_serving"] = _tdnn_serving()
    paths["tdnn_export"] = _tdnn_export(enc, tmp)
    del enc
    torch.cuda.empty_cache()
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=18)))
    paths["tdnn_step"] = _variant_step(
        TDNN_CFG, WORKERSP_CFG, raw, "TDNN.cfg + workers+",
        os.path.join(tmp, "tdnn_step"))
    paths.update(_tdnn_recipe(tmp, bf16_rate))
    paths.update(_alt_encoders())
    paths["aspp_step"] = _variant_step(
        ASPP_STEP_CFG, WORKERSP_CFG, raw,
        "narrow ASPP (QRNN, dropout off) + workers+",
        os.path.join(tmp, "aspp_step"), setup=_dropout_off)
    print(f"[encoders] phase 21 in {time.perf_counter() - t0:.1f} s")
    return paths


def _rel(a, b):
    """max|a - b| / max|b| of two tensors (on any devices)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _attention_masks(tr, raw):
    """{block: its mask} of an eval step of ``tr`` on ``raw`` (forward
    hooks on the attention blocks)."""
    from pase_tpu_torch.attention import AttentionBlock
    masks, hooks = {}, []
    for name, m in tr.model.named_children():
        if isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: masks.__setitem__(
                    name, out[1].detach())))
    try:
        tr.eval_step(raw)
    finally:
        for h in hooks:
            h.remove()
    return masks


def _attention_recipe(tmp, bf16_rate):
    """Phase 22 (a): recipes/run_pase_attention.sh's flags through the CLI
    with --synthetic for one epoch (16 x 32000, bf16), bench.py's
    distortion stack for the recipe's pase+.cfg: steps/s beside phase 8's
    bf16 rate, the blocks' running_dist sums and masks, one profiled
    step's busy split and idle share, peak memory."""
    import torch
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.profiling import profile_calls
    check(ATT_TRAIN_SHAPE in TRAIN_QRNN_SHAPES
          and ATT_TRAIN_SHAPE in QRNN_SHAPES,
          "phase 3 does not check K1 / K2 at the attention recipe's shape")
    run = os.path.join(tmp, "attention_cli")
    torch.cuda.reset_peak_memory_stats()
    dist = write_bench_dtrans_cfg(os.path.join(tmp, "attention_assets"))
    tr, launches, perf, last = _cli_run(
        _recipe_cli_argv(run, script=ATT_RECIPE) + ["--dtrans_cfg", dist],
        "the attention recipe", run, ATT_TRAIN_SHAPE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(tr.cfg["compute_dtype"] == "bfloat16"
          and (tr.batch_size, tr.chunk_size) == (16, 32000)
          and tr.model.att_cfg["K"] == ATT_K,
          f"the attention recipe's flags: {tr.cfg}")
    raw = DeviceSyntheticBatcher(tr.batch_size, tr.chunk_size,
                                 seed=22).make_batch()
    sums = {n: float(b.running_dist.sum()) for n, b in
            tr.model.named_children() if n.startswith("att_")}
    masks = _attention_masks(tr, raw)
    ones = {n: sorted(set(m.sum(dim=1).tolist())) for n, m in masks.items()}
    print(f"[options] the attention recipe's blocks after training: "
          f"running_dist sums " + ", ".join(
              f"{n[4:]} {v:.7f}" for n, v in sums.items())
          + "; ones per mask row " + ", ".join(
              f"{n[4:]} {v}" for n, v in ones.items()))
    check(len(sums) == len(tr.ordered_names) == len(masks),
          f"attention blocks {list(sums)}")
    check(all(abs(v - 1.0) <= 1e-5 for v in sums.values()),
          f"running_dist sums {sums}")
    check(all(v == [float(ATT_K)] for v in ones.values()),
          f"mask rows {ones}")
    rate = perf["steps_per_sec"]
    prof = profile_calls([lambda: tr.train_step(raw)] * 2, warmup=1,
                         spans=False)
    kinds = prof["split"]["all"]
    split = _busy_split(kinds)
    idle = max(0.0, 1.0 - prof["covered_ms"] * rate / 1e3)
    print(f"[options] the attention recipe (PASE+ + workers+ + "
          f"cfg/attention.cfg, batch 16 x 32000, bf16, the bench stack): "
          f"{rate:.3f} steps/s, {perf['audio_sec_per_sec']:.1f} audio-s/s, "
          f"against phase 8's PASE+ bf16 bench step (32 x 32000) "
          f"{bf16_rate:.3f} ({rate / bf16_rate:.3f}x); one profiled step: "
          f"device busy {prof['busy_ms']:.2f} ms (GEMM {split['matmul']:.2f},"
          f" conv {split['conv']:.2f}, rest {split['rest']:.2f}; by kind: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              kinds.items(), key=lambda kv: -kv[1]))
          + f"), covered {prof['covered_ms']:.2f} ms, wall "
          f"{prof['wall_ms']:.1f} ms profiled, {1e3 / rate:.1f} unprofiled;"
          f" idle share 1 - covered / wall {idle:.3f}; kernels per step "
          f"{prof['launches']['all']:.0f}; peak memory {peak:.2f} GiB; last "
          f"step total {last['total']:.4f}")
    del tr
    torch.cuda.empty_cache()
    return {"attention_cli": launches}


def _mask_compare(gpu, cpu):
    """After the step: each attention block's running_dist on both sides
    within ATT_DIST_REL of its largest; then, the CPU model given the
    card's parameters and buffers, the attention / chunking masks of eval
    forwards on a fresh batch must be equal. (Each side's own parameters
    after the step differ by up to 2 lr where a gradient is within
    rounding of 0, Adam's first step being +-lr: enough to move a channel
    across the K-th place.)"""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    bufs = dict(cpu.model.named_buffers())
    dist = {n[4:].split(".")[0]: _rel(b, bufs[n])
            for n, b in gpu.model.named_buffers()
            if n.endswith("running_dist")}
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=23)))
    mg, mc = _attention_masks(gpu, raw), _attention_masks(cpu, raw)
    differ = {n: int((m.cpu() != mc[n]).sum()) for n, m in mg.items()}
    chunk = {n: int(b.sum()) for n, b in gpu.model.named_buffers()
             if n.startswith("chunk_mask_")}
    print(f"[options] card vs cpu: running_dist after the step, max|d| / "
          f"max: " + (", ".join(f"{n} {v:.2e}" for n, v in dist.items())
                      or "none (no attention)")
          + f" (bound {ATT_DIST_REL}); masks of eval forwards from the "
          f"card's parameters, entries differing "
          f"{differ or 'none (no attention)'}; chunking masks' ones "
          f"{chunk or 'none (no chunking)'}")
    check(all(v <= ATT_DIST_REL for v in dist.values()),
          f"running_dist differs: {dist}")
    check(not any(differ.values()), f"attention masks differ: {differ}")
    check(all(v == ATT_K for v in chunk.values()), f"chunk masks {chunk}")


def _policy_compare(mode):
    def compare(gpu, cpu):
        bound = MGD_REL if mode == "MGD" else POLICY_REL
        errs = {"weights": _rel(gpu.last_weights, cpu.last_weights),
                "alpha": _rel(gpu.alpha, cpu.alpha)}
        for f, a, b in zip(gpu.policy_state._fields, gpu.policy_state,
                           cpu.policy_state):
            errs[f] = _rel(a.float(), b.float()) if b.abs().max() > 0 \
                else float((a.cpu() != b).any())
        print(f"[options] policy {mode}: weights "
              f"{gpu.last_weights.cpu().numpy().round(4).tolist()}, next "
              f"alpha {gpu.alpha.cpu().numpy().round(4).tolist()}; card vs "
              f"cpu max|d| / max: " + ", ".join(
                  f"{k} {v:.2e}" for k, v in errs.items())
              + f" (bound {bound})")
        check(all(v <= bound for v in errs.values()),
              f"policy {mode}: card vs cpu {errs}")
    return compare


def _optimizer_compare(rule):
    def compare(gpu, cpu):
        import torch
        from pase_tpu_torch import optim
        worst = {}
        for group_g, group_c in zip(gpu.opt.param_groups,
                                    cpu.opt.param_groups):
            check(group_g["rule"] == rule.lower(), f"rule {group_g}")
            lr = group_c["lr"]
            top = max(p.detach().abs().max().item()
                      for p in group_c["params"])
            live_err = any_err = 0.0
            for pg, pc in zip(group_g["params"], group_c["params"]):
                g = (pc.grad if pc.grad is not None
                     else torch.zeros_like(pc))
                live = g.abs() >= OPT_LIVE_REL * g.abs().max()
                diff = (pg.detach().cpu() - pc.detach()).abs()
                if live.any():
                    live_err = max(live_err, diff[live].max().item())
                any_err = max(any_err, diff.max().item())
            # the largest |u| of a first step: RMSprop's 1 / sqrt(0.1),
            # AdamW's 1 plus its decay; RAdam's and SGD's are g itself
            umax = {"rmsprop": (1 - optim.RMS_DECAY) ** -0.5,
                    "adamw": 1.0 + optim.ADAMW_DECAY * top}.get(
                        rule.lower(), 0.0)
            worst[group_c["name"]] = (live_err / top, any_err,
                                      2 * lr * umax)
            check(live_err <= OPT_PARAM_REL * top,
                  f"{rule} {group_c['name']}: live parameters {live_err}")
            check(any_err <= 2 * lr * umax + OPT_PARAM_REL * top,
                  f"{rule} {group_c['name']}: parameters {any_err}")
        print(f"[options] {rule} after one step, card vs cpu: " + "; ".join(
            f"{g}: max|dp| / max|p| where |g| >= {OPT_LIVE_REL} of its "
            f"leaf's max {a:.2e} (bound {OPT_PARAM_REL}), elsewhere max|dp|"
            f" {b:.2e} (bound 2 lr max|u| = {c:.1e})"
            for g, (a, b, c) in worst.items()))
    return compare


def _copy_head_masks(gpu, cpu):
    """The card's dropin / dropout_time masks of its step, injected into
    the CPU's modules (the two generators draw different bits)."""
    cpu_mods = dict(cpu.model.named_modules())
    n = 0
    for name, m in gpu.model.named_modules():
        if getattr(m, "last_keep", None) is not None:
            cpu_mods[name].keep = m.last_keep.cpu()
            n += 1
        if getattr(m, "last_time_keep", None) is not None:
            cpu_mods[name].time_keep = m.last_time_keep.cpu()
            n += 1
    print(f"[options] {n} dropin / dropout_time masks of the card's step "
          f"injected into the CPU's")
    check(n == 2, f"head masks found: {n}")


def _policy_cli(tmp):
    """Phase 22 (c): --backprop_mode MGD and base through the CLI at 32 x
    32000 bf16 for CLI_STEPS steps each (the epochs' rates, first
    steps included); the MGD step's pase.mgda device time."""
    import torch
    from pase_tpu_torch import train as train_cli
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.profiling import profile_calls
    paths, rates = {}, {}
    for mode in ("MGD", "base"):
        run = os.path.join(tmp, f"{mode}_cli")
        tr, paths[f"{mode.lower()}_cli"], perf, last = _variant_cli(
            PASEP_CFG, WORKERSP_CFG, f"--backprop_mode {mode}", run,
            ["--compute_dtype", "bfloat16", "--backprop_mode", mode])
        rates[mode] = perf["steps_per_sec"]
        if mode == "MGD":
            raw = DeviceSyntheticBatcher(tr.batch_size, tr.chunk_size,
                                         seed=24).make_batch()
            prof = profile_calls([lambda: tr.train_step(raw)] * 3,
                                 warmup=1)
            mgda = prof["split"].get("pase.mgda", {})
            alpha = tr.alpha.cpu().numpy()
        del tr
        torch.cuda.empty_cache()
    print(f"[options] --backprop_mode MGD through the CLI (32 x 32000, "
          f"bf16, {train_cli.SYNTHETIC_BPE} steps, the epoch's rate, first "
          f"steps included): {rates['MGD']:.3f} steps/s against "
          f"base {rates['base']:.3f} ({rates['MGD'] / rates['base']:.3f}x);"
          f" a profiled MGD step: wall {prof['wall_ms']:.1f} ms, busy "
          f"{prof['busy_ms']:.2f} ms, pase.mgda {sum(mgda.values()):.2f} ms"
          f" (" + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              mgda.items(), key=lambda kv: -kv[1]))
          + f"), pase.losses {sum(prof['split'].get('pase.losses', {}).values()):.2f} ms"
          f"; the last alpha {alpha.round(3).tolist()} (sum "
          f"{alpha.sum():.6f})")
    check(sum(mgda.values()) > 0, "no device time in pase.mgda")
    check(abs(alpha.sum() - 1) < 1e-5 and (alpha >= 0).all(),
          f"MGD alpha off the simplex: {alpha}")
    return paths


def _step_rates(tmp):
    """Phase 22 (c), (d): steady-state steps/s of the PASE+ / workers+
    bf16 step at 32 x 32000 under the value-sensitive policies (their
    losses in float32) and each optimizer, beside the base step (Adam in
    both groups), in turns in this process: STEP_RATE_ROUNDS rounds of 4
    timed steps after a warm one. The library's reference: the base step
    with torch.optim.Adam (foreach) in place of the port's Adam."""
    import torch
    from pase_tpu_torch import optim
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.trainer import Trainer
    cfg = dict(backprop_mode="base", hop=160, bpe=100, epoch=1,
               batch_size=TRAIN_BATCH, chunk_size=TRAIN_CHUNK,
               compute_dtype="bfloat16")
    variants = {"base": {}, "MGD": {"backprop_mode": "MGD"},
                "softmax": {"backprop_mode": "softmax"},
                **{r: {"fe_opt": r, "min_opt": r} for r in OPTIMIZERS},
                "torch.optim.Adam": {}}
    trainers = {k: Trainer(PASEP_CFG, WORKERSP_CFG, dict(
        cfg, save_path=os.path.join(tmp, f"rate_{k}"), **v), device="cuda")
        for k, v in variants.items()}
    lib = trainers["torch.optim.Adam"]
    lib.opt = torch.optim.Adam(
        [{"params": g["params"], "name": g["name"], "lr": g["lr"]}
         for g in lib.opt.param_groups],
        betas=(optim.B1, optim.B2), eps=optim.EPS, foreach=True)
    batcher = DeviceSyntheticBatcher(TRAIN_BATCH, TRAIN_CHUNK, seed=25)
    batches = [batcher.make_batch() for _ in range(5)]
    rates = {k: [] for k in trainers}
    for _ in range(STEP_RATE_ROUNDS):
        for k, tr in trainers.items():
            rates[k].append(_timed_steps(tr, batches, warm=1)[0])
    del trainers, lib
    torch.cuda.empty_cache()
    base = rates["base"]
    lines = []
    for k, rs in rates.items():
        ratio = [r / b for r, b in zip(rs, base)]
        lines.append(
            f"{k} {np.mean(rs):.3f} (rounds " + ", ".join(
                f"{r:.3f}" for r in rs)
            + f"; spread (max - min) / mean "
            f"{(max(rs) - min(rs)) / np.mean(rs):.3f})"
            + ("" if k == "base" else
               f", against base {np.mean(ratio):.3f}x [{min(ratio):.3f}, "
               f"{max(ratio):.3f}]"))
    print(f"[options] steady-state steps/s, PASE+ / workers+ 32 x 32000 "
          f"bf16, {STEP_RATE_ROUNDS} rounds of 4 steps after a warm one, "
          f"in turns: " + "; ".join(lines))
    check(all(r > 0 for rs in rates.values() for r in rs),
          f"step rates {rates}")
    return rates


def phase_options(tmp, bf16_rate):
    """Phase 22: the attention recipe, the variants' and policies' steps,
    the optimizers and the other heads on the card. Returns {path: launch
    counts}."""
    import torch
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.data.pipeline import compute_stats
    from pase_tpu_torch.model import parse_workers_cfg
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    paths = _attention_recipe(tmp, bf16_rate)
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=22)))
    for label, extra in (("attention", {"att_cfg": ATT_CFG}),
                         ("chunking", {"chunking_K": ATT_K})):
        paths[f"{label}_step"] = _variant_step(
            PASEP_CFG, WORKERSP_CFG, raw, f"PASE+ workers+ {label}",
            os.path.join(tmp, f"{label}_step"), cfg_extra=extra,
            compare=_mask_compare)
    rng = np.random.RandomState(22)
    meta = parse_workers_cfg(WORKERSP_CFG)
    n = len(meta["cls"] + meta["regr"])
    # ZNorm'd targets: the losses the policies read are then O(1), so
    # softmax / hyper_volume / adaptive do not saturate
    stats = compute_stats(SyntheticChunkBatcher(8, 32000, seed=8), meta,
                          max_batches=2, device="cuda")
    for mode in POLICIES:
        kw = {}
        if mode in ("select_half", "dropout"):
            w = np.zeros(n, np.float32)
            w[rng.choice(n, 3 if mode == "select_half" else n // 2,
                         replace=False)] = 1.0
            kw = {"policy_weights": torch.from_numpy(w)}
        paths[f"policy_{mode}_step"] = _variant_step(
            PASEP_CFG, WORKERSP_CFG, raw, f"PASE+ workers+ policy {mode}",
            os.path.join(tmp, f"policy_{mode}"),
            cfg_extra={"backprop_mode": mode}, step_kw=kw,
            compare=_policy_compare(mode), stats=stats)
    paths.update(_policy_cli(tmp))
    for rule in OPTIMIZERS:
        paths[f"opt_{rule.lower()}_step"] = _variant_step(
            PASEP_CFG, WORKERSP_CFG, raw, f"PASE+ workers+ {rule}",
            os.path.join(tmp, f"opt_{rule}"),
            cfg_extra={"fe_opt": rule, "min_opt": rule},
            compare=_optimizer_compare(rule))
    _step_rates(tmp)
    workers = parse_workers_cfg(WORKERSP_CFG)
    for e in workers["regr"]:
        if e["name"] == "mfcc":
            e.update(HEAD_OPTIONS)
    workers["regr"].append({"name": "lpc", "type": "mlp",
                            "num_outputs": 26, "hidden_size": 256,
                            "hidden_layers": 1, "loss": "MSELoss",
                            "skip": False, "loss_weight": 1.0})
    workers["regu"] = [{"name": "regu_cchunk", "loss": "MSELoss",
                        "type": "mlp", "loss_weight": 1.0}]
    noisy = dict(raw, cchunk=raw["chunk"],
                 chunk=raw["chunk"] + 0.05 * rng.randn(
                     *raw["chunk"].shape).astype(np.float32))
    paths["regu_step"] = _variant_step(
        PASEP_CFG, workers, noisy,
        "PASE+ workers+ with regu_cchunk, lpc and mfcc's dropin / tied "
        "context / dropout_time", os.path.join(tmp, "regu_step"),
        between=_copy_head_masks)
    print(f"[options] phase 22 in {time.perf_counter() - t0:.1f} s")
    return paths


def _ami_corpus(tmp):
    """Phase 23 (a): the seeded AMI meeting tree written by the port's
    synthetic_corpus, segmented and described by its data_prep
    (ami-segment, ami-cfg --map_ihm2sdm 1,3,5,7; the last meeting the
    test split), and a tree-mode sdm tree: channel 1's segment under each
    headset segment's name. Returns {seg, cfg, sdm}."""
    import glob
    from pase_tpu_torch import data_prep
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_ami
    t0 = time.perf_counter()
    tree = os.path.join(tmp, "amicorpus")
    meetings = write_synthetic_ami(tree, AMI_MEETINGS, AMI_MEETING_S, seed=0)
    t1 = time.perf_counter()
    ids = os.path.join(tmp, "meetings.txt")
    with open(ids, "w") as f:
        f.write("\n".join(meetings))
    seg = os.path.join(tmp, "ami_seg")
    data_prep.main(["ami-segment", "--data_root", tree, "--out_root", seg,
                    "--ami_meeting_ids", ids, "--map_ihm2sdm", AMI_CHANS])
    t2 = time.perf_counter()
    scps = {}
    for split, meets in (("train", meetings[:-1]), ("test", meetings[-1:])):
        scps[split] = os.path.join(tmp, f"ami_{split}.scp")
        with open(scps[split], "w") as f:
            f.write("\n".join(sorted(p for m in meets for p in glob.glob(
                os.path.join(seg, m, "audio", "*.wav")))))
    cfg = os.path.join(tmp, "ami_data_ihm_sdm.cfg")
    data_prep.main(["ami-cfg", "--data_root", seg, "--train_scp",
                    scps["train"], "--test_scp", scps["test"], "--cfg_file",
                    cfg, "--map_ihm2sdm", AMI_CHANS])
    sdm = os.path.join(tmp, "ami_sdm")
    with open(cfg) as f:
        js = json.load(f)
    for split in ("train", "valid", "test"):
        for e in js[split]["data"]:
            dst = os.path.join(sdm, e["filename"])
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.link(os.path.join(seg, e["1"]), dst)
    shutil.rmtree(tree)
    hours = {s: js[s]["total_wav_dur"] / SR / 3600 for s in js
             if isinstance(js[s], dict)}
    check(all(set(e) == {"filename", "spk", "1", "3", "5", "7"}
              for s in hours for e in js[s]["data"]),
          "ami-cfg entries without the four distant channels")
    print(f"[ami] corpus: {AMI_MEETINGS} meetings of {AMI_MEETING_S:.0f} s "
          f"(4 headsets, 8 Array1 channels) written in {t1 - t0:.1f} s; "
          f"python -m pase_tpu_torch.data_prep ami-segment --map_ihm2sdm "
          f"{AMI_CHANS}: {len(glob.glob(os.path.join(seg, '*', 'audio', '*.wav')))} "
          f"segment wavs in {t2 - t1:.1f} s; ami-cfg: " + ", ".join(
              f"{s} {len(js[s]['data'])} segments {h:.3f} h"
              for s, h in hours.items())
          + f" of headset audio ({time.perf_counter() - t2:.1f} s)")
    return {"seg": seg, "cfg": cfg, "sdm": sdm, "n_train": len(
        js["train"]["data"])}


def _cut_cfg(src, dst, root, every=AMI_CUT):
    """A data cfg keeping every ``every``-th utterance of its train split,
    its total_wav_dur recounted from the wavs."""
    from pase_tpu_torch.data.io import wav_len
    with open(src) as f:
        cfg = json.load(f)
    cfg["train"]["data"] = cfg["train"]["data"][::every]
    cfg["train"]["total_wav_dur"] = sum(
        wav_len(os.path.join(root, e["filename"]))
        for e in cfg["train"]["data"])
    with open(dst, "w") as f:
        json.dump(cfg, f)
    return dst


def _corpus_dropped(argv, index):
    """``argv`` without the ``index``-th corpus of its concatenation: the
    index-th value of each of CORPUS_FLAGS (and --clean_root with the AMI
    part, the second)."""
    seen, out, i = {}, [], 0
    while i < len(argv):
        flag = argv[i]
        width = 2 if i + 1 < len(argv) and not argv[i + 1].startswith(
            "--") else 1
        n = seen.get(flag, 0)
        seen[flag] = n + 1
        if (flag in CORPUS_FLAGS and n == index) or (
                flag == "--clean_root" and index == 1):
            i += width
            continue
        out += argv[i:i + width]
        i += width
    return out


def _ami_recipe_argv(save, env, dist, values=None):
    """recipes/run_pase_libri_ami.sh's flags with the recipe's variables
    from ``env``, one epoch, cfg paths under this checkout, the
    distortion cfg whose assets are absent (cfg/distortions/pase+.cfg)
    replaced by bench.py's stack ``dist``, ``values`` ({flag: value})
    replacing the recipe's."""
    argv = recipe_argv(AMI_RECIPE, dict(env, SAVE_PATH=save))
    values = {"--epoch": "1", **(values or {})}
    out = []
    for i, w in enumerate(argv):
        if i and argv[i - 1] in values:
            out.append(values[argv[i - 1]])
        elif w == "cfg/distortions/pase+.cfg":
            out.append(dist)
        elif w.startswith("cfg/"):
            out.append(os.path.join(HERE, w))
        else:
            out.append(w)
    return out + ["--log_freq", "25"]


def _ami_recipe(tmp, ami, bf16_rate):
    """Phase 23 (a): the recipe through the CLI for one epoch at its width
    (PASE+, workers.cfg, 32 x 32000, bf16): the LibriSpeech part with the
    bench stack, the AMI part in tree mode with --dtrans_cfg None and the
    headset tree as --clean_root; the share of rows whose distortion mask
    was off against the AMI share of the corpus; the same flags with
    --synthetic in this process; then a shorter epoch in channel-key mode
    and one in tree mode from the device corpus. Returns (paths, the
    runs' save paths, the LibriSpeech wav root and its cut cfg, and the
    recipe's argv)."""
    import torch
    from pase_tpu_torch import make_trainset_statistics
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
    from pase_tpu_torch.trainer import Trainer
    check(TRAIN_SHAPE in TRAIN_QRNN_SHAPES and TRAIN_SHAPE in QRNN_SHAPES,
          "phase 3 does not check K1 / K2 at the recipe's [96,200,512]")
    t0 = time.perf_counter()
    libri_root, libri_cfg = write_synthetic_corpus(
        os.path.join(tmp, "libri"), AMI_LIBRI_S, 60, seed=1)
    stats = os.path.join(tmp, "libri_ami_ihm_stats.pkl")
    net_cfg = os.path.join(HERE, "cfg", "workers", "workers.cfg")
    make_trainset_statistics.main([
        "--data_root", libri_root, "--data_cfg", libri_cfg, "--net_cfg",
        net_cfg, "--out_file", stats, "--batch_size", str(TRAIN_BATCH),
        "--chunk_size", str(TRAIN_CHUNK), "--max_batches", "2"])
    dist = write_bench_dtrans_cfg(os.path.join(tmp, "ami_assets"))
    print(f"[ami] the LibriSpeech part ({AMI_LIBRI_S} s, seeded) and its "
          f"statistics (make_trainset_statistics, workers.cfg) in "
          f"{time.perf_counter() - t0:.1f} s")
    env = {"STATS": stats, "LIBRI_ROOT": libri_root, "LIBRI_CFG": libri_cfg,
           "AMI_SDM_ROOT": ami["sdm"], "AMI_CFG": ami["cfg"],
           "AMI_IHM_ROOT": ami["seg"]}
    saves = {k: os.path.join(tmp, k) for k in (
        "ami_cli", "ami_synthetic", "ami_channel_key", "ami_device_corpus")}
    argv = _ami_recipe_argv(saves["ami_cli"], env, dist)
    masks = []
    step = Trainer.train_step

    def counting(self, raw, *a, **k):
        batch = self.ready(raw)
        if "dist_mask" in batch:         # a device sum: no synchronization
            masks.append((batch["dist_mask"] == 0).sum())
        return step(self, batch, *a, **k)

    Trainer.train_step = counting
    try:
        tr, launches, perf, _ = _cli_run(argv, "the AMI recipe",
                                         saves["ami_cli"])
    finally:
        Trainer.train_step = step
    check(tr.cfg["compute_dtype"] == "bfloat16" and (tr.batch_size,
          tr.chunk_size) == (TRAIN_BATCH, TRAIN_CHUNK)
          and tr.cfg["dataset"] == ["LibriSpeechSegTupleWavDataset",
                                    "AmiSegTupleWavDataset"]
          and tr.cfg["dtrans_cfg"] == [dist, "None"],
          f"the AMI recipe's flags: {tr.cfg}")
    rows = TRAIN_BATCH * len(masks)
    off = float(sum(int(m) for m in masks)) / rows
    with open(libri_cfg) as f:
        n_libri = len(json.load(f)["train"]["data"])
    share = ami["n_train"] / (ami["n_train"] + n_libri)
    sd = (share * (1 - share) / rows) ** 0.5
    print(f"[ami] distortion mask off on {off:.4f} of the {rows} rows the "
          f"steps read; the AMI share of the concatenated train corpus "
          f"{share:.4f} ({ami['n_train']} of {ami['n_train'] + n_libri} "
          f"utterances, drawn uniformly); binomial sd {sd:.4f}")
    check(len(masks) == tr.bpe and abs(off - share) <= 5 * sd,
          f"mask-off share {off} against the AMI share {share}")
    del tr
    # the same flags with --synthetic: the corpora dropped, the bench stack
    # and the statistics kept
    sargv = _corpus_dropped(argv, 1)
    for flag in ("--data_root", "--data_cfg", "--dataset"):
        k = sargv.index(flag)
        del sargv[k:k + 2]
    sargv[sargv.index("--save_path") + 1] = saves["ami_synthetic"]
    trs, synth_launches, sperf, _ = _cli_run(
        sargv + ["--synthetic"], "the AMI recipe's flags, --synthetic",
        saves["ami_synthetic"])
    del trs
    rate, srate = perf["steps_per_sec"], sperf["steps_per_sec"]
    print(f"[ami] the AMI recipe (PASE+, workers.cfg, 32 x 32000, bf16, "
          f"LibriSpeech with the bench stack + AMI tree mode undistorted): "
          f"{rate:.3f} steps/s = {rate / srate:.3f} x the same flags with "
          f"--synthetic ({srate:.3f}) = {rate / bf16_rate:.3f} x phase 8's "
          f"PASE+ / workers+ bf16 bench step ({bf16_rate:.3f}); host wait "
          f"for the next batch {perf['feed_wait_ms']:.2f} ms/step, staging "
          f"{perf['stage_ms']:.2f} ms/step (--synthetic: "
          f"{sperf['feed_wait_ms']:.2f}, {sperf['stage_ms']:.2f})")
    torch.cuda.empty_cache()
    # the shorter epochs: every AMI_CUT-th utterance of each corpus
    cut_libri = _cut_cfg(libri_cfg, os.path.join(tmp, "libri_cut.cfg"),
                         libri_root)
    cut_ami = _cut_cfg(ami["cfg"], os.path.join(tmp, "ami_cut.cfg"),
                       ami["seg"])
    ck_argv = _ami_recipe_argv(saves["ami_channel_key"], dict(
        env, LIBRI_CFG=cut_libri, AMI_CFG=cut_ami, AMI_SDM_ROOT=ami["seg"]),
        dist) + ["--ihm2sdm", AMI_CHANS]
    tr, ck_launches, ck_perf, _ = _cli_run(
        ck_argv, "the AMI recipe, channel-key mode (--ihm2sdm 1,3,5,7)",
        saves["ami_channel_key"])
    check(tr.cfg["ihm2sdm"] == AMI_CHANS, "--ihm2sdm did not reach the CLI")
    del tr
    dc_argv = _corpus_dropped(_ami_recipe_argv(
        saves["ami_device_corpus"], dict(env, AMI_CFG=cut_ami), dist), 0)
    tr, dc_launches, dc_perf, _ = _cli_run(
        dc_argv + ["--device_corpus"],
        "the AMI part alone, tree mode, --device_corpus",
        saves["ami_device_corpus"])
    check(tr.cfg["dataset"] == ["AmiSegTupleWavDataset"]
          and tr.cfg["device_corpus"], f"device corpus flags {tr.cfg}")
    del tr
    torch.cuda.empty_cache()
    print(f"[ami] shorter epochs: channel-key mode {ck_perf['steps_per_sec']:.3f} "
          f"steps/s (feed wait {ck_perf['feed_wait_ms']:.2f} ms/step), the "
          f"device corpus in tree mode {dc_perf['steps_per_sec']:.3f} "
          f"steps/s (feed wait {dc_perf['feed_wait_ms']:.2f} ms/step)")
    return ({"ami_cli": launches, "ami_channel_key": ck_launches,
             "ami_device_corpus": dc_launches}, saves,
            (libri_root, cut_libri), argv)


def _tools(tmp, saves, libri, recipe, dist_perf):
    """Phase 23 (b): profile-step at PASE+ / workers+ 32 x 32000 in bf16
    and float32 against phase 8's rates; eval-ckpts over (a)'s three
    encoder artifacts; precompute-feats over the cut LibriSpeech part,
    then a --cache_feats_dir epoch. Returns the paths."""
    import torch
    from pase_tpu_torch import util_scripts
    libri_root, cut_libri = libri
    with open(PASEP_CFG) as f:
        layers = json.load(f).get("rnn_layers", 1)
    paths = {}
    reset_launches()                         # profile-step starts here
    lines = {}
    for dtype in ("bfloat16", "float32"):
        lines[dtype] = util_scripts.main([
            "profile-step", "--fe_cfg", PASEP_CFG, "--net_cfg",
            WORKERSP_CFG, "--batch_size", str(TRAIN_BATCH), "--chunk_size",
            str(TRAIN_CHUNK), "--compute_dtype", dtype])
    torch.cuda.synchronize()
    paths["profile_step"] = read_launches()  # ... and ends here
    steps = 2 * (3 + 20)                     # warm-up and timed, each dtype
    expected = {**{k: 0 for k in paths["profile_step"]},
                "qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps}
    check(paths["profile_step"] == expected,
          f"profile-step launches {paths['profile_step']} != {expected}")
    for dtype, line in lines.items():
        ref = dist_perf[dtype]["steps_per_sec"]
        print(f"[tools] python -m pase_tpu_torch.util_scripts profile-step "
              f"(PASE+ / workers+, 32 x 32000, {dtype}, the bench stack): "
              f"{json.dumps(line)}; against phase 8's {dtype} rate "
              f"{ref:.3f}: {line['steps_per_sec'] / ref:.3f}x")
        check(set(line) == {"prepare_ms", "step_ms", "model_opt_ms",
                            "steps_per_sec", "audio_sec_per_sec"}
              and line["step_ms"] > line["prepare_ms"] > 0,
              f"profile-step line {line}")
    ckpts = os.path.join(tmp, "ami_ckpts")
    os.makedirs(ckpts)
    runs = ("ami_cli", "ami_channel_key", "ami_device_corpus")
    for e, run in enumerate(runs):
        shutil.copy(os.path.join(saves[run], "FE_e0.npz"),
                    os.path.join(ckpts, f"FE_e{e}.npz"))
    out = os.path.join(tmp, "ckpt_losses.json")
    reset_launches()                         # eval-ckpts starts here
    t0 = time.perf_counter()
    results = util_scripts.main([
        "eval-ckpts", "--fe_cfg", PASEP_CFG, "--net_cfg",
        os.path.join(HERE, "cfg", "workers", "workers.cfg"), "--ckpt_dir",
        ckpts, "--data_root", libri_root, "--data_cfg", cut_libri,
        "--batch_size", str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK),
        "--n_batches", str(EVAL_CKPT_BATCHES), "--out_file", out,
        "--save_path", os.path.join(tmp, "eval_log")])
    torch.cuda.synchronize()
    paths["eval_ckpts"] = read_launches()    # ... and ends here
    expected = {**{k: 0 for k in paths["eval_ckpts"]},
                k1_eval(TRAIN_SHAPE): layers * EVAL_CKPT_BATCHES
                * len(runs)}
    check(paths["eval_ckpts"] == expected,
          f"eval-ckpts launches {paths['eval_ckpts']} != {expected}")
    with open(out) as f:
        written = json.load(f)
    check(written == results and list(written) == [
        f"FE_e{e}.npz" for e in range(len(runs))] and all(
        np.isfinite(v) for v in written.values()),
          f"eval-ckpts output {written}")
    print(f"[tools] eval-ckpts over the AMI runs' artifacts ({', '.join(runs)}"
          f"), {EVAL_CKPT_BATCHES} batches of 32 x 32000 of the LibriSpeech "
          f"valid split each, in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(written)}")
    cache = os.path.join(tmp, "feats")
    t0 = time.perf_counter()
    n = util_scripts.main(["precompute-feats", "--net_cfg", os.path.join(
        HERE, "cfg", "workers", "workers.cfg"), "--data_root", libri_root,
        "--data_cfg", cut_libri, "--out_dir", cache])
    size = sum(os.path.getsize(os.path.join(cache, f))
               for f in os.listdir(cache))
    print(f"[tools] precompute-feats over the cut LibriSpeech part: {n} "
          f"caches, {size / 1e6:.1f} MB, in {time.perf_counter() - t0:.1f} s")
    run = os.path.join(tmp, "cache_feats")
    argv = _corpus_dropped(recipe, 1)
    argv[argv.index("--data_cfg") + 1] = cut_libri
    argv[argv.index("--random_scale") + 1] = "False"
    argv[argv.index("--save_path") + 1] = run
    tr, paths["cache_feats"], perf, _ = _cli_run(
        argv + ["--cache_feats_dir", cache],
        "the recipe's LibriSpeech part from the feature cache", run)
    print(f"[tools] --cache_feats_dir epoch: {perf['steps_per_sec']:.3f} "
          f"steps/s, feed wait {perf['feed_wait_ms']:.2f} ms/step, staging "
          f"{perf['stage_ms']:.2f} ms/step")
    del tr
    torch.cuda.empty_cache()
    return paths


def _reference_pase_sd(model, meta):
    """A port PASE's state dict under the reference ``pase`` model's keys
    (frontend., regression_workers.{i}., classification_workers.{i}.minion.)."""
    regr = [e["name"] for e in meta["regr"]]
    cls = [e["name"] for e in meta["cls"]]
    out = {}
    for k, v in model.state_dict().items():
        top, _, rest = k.partition(".")
        if top == "frontend":
            out[k] = v.cpu()
            continue
        name, _, leaf = rest.partition(".")
        out[(f"regression_workers.{regr.index(name)}." if name in regr else
             f"classification_workers.{cls.index(name)}.minion.")
            + leaf] = v.cpu()
    return out


def _layouts(tmp, saves):
    """Phase 23 (c): export-torch of the AMI recipe's artifact, loaded
    back (load_frontend_ckpt): the encoder's forward on the card equals
    the original's bit for bit; a reference-keyed whole-model state dict
    of a seeded PASE+ / workers+ loaded into another seed's model
    (load_reference_pase_ckpt): one step's losses equal the original's
    bit for bit."""
    import torch
    from pase_tpu_torch import util_scripts, wf_builder
    from pase_tpu_torch.checkpoint import load_reference_pase_ckpt
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.trainer import Trainer
    npz = os.path.join(saves["ami_cli"], "FE_e0.npz")
    ckpt = os.path.join(tmp, "FE_e0.ckpt")
    out = util_scripts.main(["export-torch", "--in_ckpt", npz, "--out_ckpt",
                             ckpt])
    a = wf_builder(PASEP_CFG).load_pretrained(npz)
    b = wf_builder(PASEP_CFG, seed=7).load_pretrained(ckpt)
    x = np.random.RandomState(23).randn(4, 1, TRAIN_CHUNK).astype(np.float32)
    ya, yb = a(x), b(x)
    check(torch.equal(ya, yb), "export-torch round trip: the forwards differ "
          f"by {(ya - yb).abs().max().item()}")
    print(f"[layouts] export-torch of the AMI recipe's FE_e0.npz: "
          f"{len(out)} tensors "
          f"({sum(k.endswith('num_batches_tracked') for k in out)} "
          f"num_batches_tracked); loaded back with load_frontend_ckpt, the "
          f"forward at (4,1,32000) on the card equals the original's bit "
          f"for bit")
    del a, b
    cfg = dict(backprop_mode="base", hop=160, bpe=100, epoch=1,
               batch_size=4, chunk_size=TRAIN_CHUNK)
    src = Trainer(PASEP_CFG, WORKERSP_CFG, dict(cfg, seed=0, save_path=
                  os.path.join(tmp, "ref_src")), device="cuda")
    dst = Trainer(PASEP_CFG, WORKERSP_CFG, dict(cfg, seed=1, save_path=
                  os.path.join(tmp, "ref_dst")), device="cuda")
    sd = _reference_pase_sd(src.model, src.meta)
    path = os.path.join(tmp, "PASE-ref.ckpt")
    torch.save(sd, path)
    load_reference_pase_ckpt(path, dst.model, dst.meta)
    raw = DeviceSyntheticBatcher(4, TRAIN_CHUNK, seed=23).make_batch()
    la, lb = src.train_step(raw), dst.train_step(raw)
    bad = [k for k in la if not torch.equal(la[k], lb[k])]
    check(not bad, f"reference-layout model: losses differ at {bad}")
    print(f"[layouts] a reference-keyed PASE+ / workers+ state dict "
          f"({len(sd)} keys, {len(src.meta['regr'])} regression and "
          f"{len(src.meta['cls'])} classification workers) loaded with "
          f"load_reference_pase_ckpt into a model of another seed: one step "
          f"at 4 x 32000 gives the original's {len(la)} losses bit for bit "
          f"(total {float(la['total']):.6f})")
    del src, dst
    torch.cuda.empty_cache()


def _trainer_rows(tmp):
    """Phase 23 (d): one PASE+ / workers+ step at 2 x 16000 with
    log_histograms and log_grad_norms on the card and on the CPU, from the
    same weights and the same (CPU-computed) regression targets: the
    histogram rows' lo / hi within HIST_REL, their counts moved only by
    values within HIST_EDGE_REL (hi - lo) of an edge, the grad norms
    within GRAD_NORM_REL; then the bf16 step at 32 x 32000 with
    fused_heads=False against the fused default in turns, STEP_RATE_ROUNDS
    rounds of 4 steps after a warm one."""
    import torch
    from pase_tpu_torch import trainer as port_trainer
    from pase_tpu_torch.data.dataset import (DeviceSyntheticBatcher,
                                             SyntheticChunkBatcher)
    from pase_tpu_torch.data.pipeline import make_prepare_fn
    from pase_tpu_torch.model import parse_workers_cfg
    from pase_tpu_torch.trainer import Trainer
    meta = parse_workers_cfg(WORKERSP_CFG)
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=23)))
    with torch.no_grad():
        prep = make_prepare_fn(meta)(
            {k: torch.from_numpy(v) for k, v in raw.items()})
    raw.update({e["name"]: prep[e["name"]].numpy() for e in meta["regr"]
                if e["name"] != "cchunk"})
    rows, values = {}, {}
    hist = port_trainer.hist_row
    for device in ("cuda", "cpu"):
        tr = Trainer(PASEP_CFG, WORKERSP_CFG, dict(
            batch_size=2, chunk_size=16000, log_histograms=True,
            log_grad_norms=True, save_path=os.path.join(tmp, f"rows_{device}")),
            device=device)
        seen = values.setdefault(device, [])

        def recording(x, bins=24, seen=seen):
            seen.append(x.detach().reshape(-1).double().cpu().numpy())
            return hist(x, bins)

        port_trainer.hist_row = recording
        try:
            rows[device] = {k: v.cpu().numpy() for k, v in
                            tr.train_step(raw).items()}
        finally:
            port_trainer.hist_row = hist
        del tr
    gpu, cpu = rows["cuda"], rows["cpu"]
    names = [k for k in cpu if k.startswith("hist/")]
    check(len(names) == 2 * len(meta["regr"] + meta["cls"])
          and set(gpu) == set(cpu), f"rows {sorted(gpu)}")
    worst = {"lohi": 0.0, "moved": 0, "near": 0, "norm": 0.0}
    for i, k in enumerate(names):
        lo, hi = cpu[k][0], cpu[k][1]
        worst["lohi"] = max(worst["lohi"], float(
            np.abs(gpu[k][:2] - cpu[k][:2]).max() / max(abs(lo), abs(hi))))
        edges = lo + (hi - lo + 1e-9) * np.arange(25) / 24
        near = int((np.abs(values["cpu"][i][:, None] - edges[None, 1:-1])
                    <= HIST_EDGE_REL * (hi - lo)).any(axis=1).sum())
        moved = int(np.abs(gpu[k][2:] - cpu[k][2:]).sum())
        worst["moved"] += moved
        worst["near"] += near
        check(moved <= 2 * near, f"{k}: {moved} counts moved, {near} values "
              "near an edge")
    for k in (k for k in cpu if k.startswith("grad_norm/")):
        worst["norm"] = max(worst["norm"], abs(float(gpu[k]) - float(
            cpu[k])) / float(cpu[k]))
    check(worst["lohi"] <= HIST_REL and worst["norm"] <= GRAD_NORM_REL,
          f"trainer rows card vs CPU: {worst}")
    print(f"[f2] log_histograms / log_grad_norms, PASE+ / workers+ 2 x 16000,"
          f" card vs CPU: {len(names)} histogram rows, lo / hi within "
          f"{worst['lohi']:.2e} of the row's largest, {worst['moved']} counts "
          f"moved in all ({worst['near']} values within {HIST_EDGE_REL} "
          f"(hi - lo) of an edge); {sum(k.startswith('grad_norm/') for k in cpu)}"
          f" grad norms within {worst['norm']:.2e} relative")
    cfg = dict(backprop_mode="base", hop=160, bpe=100, epoch=1,
               batch_size=TRAIN_BATCH, chunk_size=TRAIN_CHUNK,
               compute_dtype="bfloat16")
    trainers = {k: Trainer(PASEP_CFG, WORKERSP_CFG, dict(
        cfg, fused_heads=k == "fused", save_path=os.path.join(tmp, k)),
        device="cuda") for k in ("fused", "unfused")}
    batches = [DeviceSyntheticBatcher(TRAIN_BATCH, TRAIN_CHUNK,
                                      seed=24).make_batch() for _ in range(5)]
    rates = {k: [] for k in trainers}
    for _ in range(STEP_RATE_ROUNDS):
        for k, tr in trainers.items():
            rates[k].append(_timed_steps(tr, batches, warm=1)[0])
    del trainers
    torch.cuda.empty_cache()
    ratio = [u / f for u, f in zip(rates["unfused"], rates["fused"])]
    print(f"[f2] fused_heads=False against the fused default, PASE+ / "
          f"workers+ 32 x 32000 bf16, steady state ({STEP_RATE_ROUNDS} rounds"
          f" of 4 steps after a warm one, in turns): unfused " + ", ".join(
              f"{r:.3f}" for r in rates["unfused"]) + " steps/s, fused "
          + ", ".join(f"{r:.3f}" for r in rates["fused"])
          + f"; ratio {np.mean(ratio):.3f}x [{min(ratio):.3f}, "
          f"{max(ratio):.3f}]; ms per step {1e3 / np.mean(rates['unfused']):.2f}"
          f" against {1e3 / np.mean(rates['fused']):.2f}")


def phase_ami(tmp, dist_perf):
    """Phase 23: AMI pretraining end to end, the step-level tools, the
    reference layouts and the trainer's rows."""
    t0 = time.perf_counter()
    ami = _ami_corpus(tmp)
    paths, saves, libri, recipe = _ami_recipe(
        tmp, ami, dist_perf["bfloat16"]["steps_per_sec"])
    shutil.rmtree(ami["sdm"])
    paths.update(_tools(tmp, saves, libri, recipe, dist_perf))
    _layouts(tmp, saves)
    _trainer_rows(tmp)
    print(f"[ami] phase 23 in {time.perf_counter() - t0:.1f} s")
    return paths


def write_kaldi_workers_cfg(root):
    """workers+.cfg with the two Kaldi heads, each a copy of its mfcc head
    (hidden 256, one layer, r 7, MSE) with its outputs and transform."""
    with open(WORKERSP_CFG) as f:
        wk = json.load(f)
    mfcc = next(e for e in wk["regr"] if e["name"] == "mfcc")
    for name, n_out, transform in KALDI_HEADS:
        wk["regr"].append(dict(mfcc, name=name, num_outputs=n_out,
                               transform=dict(transform)))
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "workers+kaldi.cfg")
    with open(path, "w") as f:
        json.dump(wk, f)
    return path


def _kaldi_targets_card_vs_cpu():
    """The two Kaldi targets of one clean 32 x 32000 batch on the card and
    on the CPU: max|diff| / max|cpu| of each."""
    import torch
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.ops.features import feature_fn_for_worker
    wav = torch.from_numpy(next(iter(SyntheticChunkBatcher(
        TRAIN_BATCH, TRAIN_CHUNK, seed=24)))["chunk"])
    errs = {}
    for name, n_out, transform in KALDI_HEADS:
        fn = feature_fn_for_worker(name, transform)
        cpu, card = fn(wav), fn(wav.cuda()).cpu()
        check(cpu.shape == card.shape == (TRAIN_BATCH, TRAIN_CHUNK // 160,
                                          n_out)
              and torch.isfinite(card).all(), f"{name} target {card.shape}")
        errs[name] = ((card - cpu).abs().max() / cpu.abs().max()).item()
    return errs


def _kaldi_step(tmp, bf16_rate):
    """Phase 24 (a): the PASE+ / workers+ + Kaldi heads recipe through the
    training CLI (32 x 32000, bf16, the bench stack, ZNorm statistics of
    make_trainset_statistics), then its step against phase 8's bench step
    in this process: steady-state steps/s in turns, each one's pase.prepare
    device ms and launches per step; the Kaldi targets card vs CPU.
    Returns (paths, the CLI run's save path, stats, worker cfg, bench
    distortion cfg)."""
    import torch
    from pase_tpu_torch import bench, make_trainset_statistics
    from pase_tpu_torch.data.dataset import (DeviceSyntheticBatcher,
                                             SyntheticChunkBatcher)
    from pase_tpu_torch.data.pipeline import compute_stats, load_stats_pkl
    from pase_tpu_torch.model import parse_workers_cfg
    from pase_tpu_torch.trainer import Trainer
    net_cfg = write_kaldi_workers_cfg(os.path.join(tmp, "cfg"))
    stats = os.path.join(tmp, "kaldi_stats.pkl")
    t0 = time.perf_counter()
    make_trainset_statistics.main([
        "--synthetic", "--net_cfg", net_cfg, "--out_file", stats,
        "--batch_size", str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK),
        "--max_batches", "2"])
    st = load_stats_pkl(stats)
    check(all(np.isfinite(st[k][m]).all() and (st[k]["std"] > 0).all()
              for k, _, _ in KALDI_HEADS for m in ("mean", "std"))
          and [st[k]["mean"].shape[0] for k, _, _ in KALDI_HEADS]
          == [n for _, n, _ in KALDI_HEADS],
          f"Kaldi statistics {[(k, st.get(k)) for k, _, _ in KALDI_HEADS]}")
    print(f"[kaldi] make_trainset_statistics --synthetic (workers+ and the "
          f"Kaldi heads, 2 batches of 32 x 32000): {len(st)} targets in "
          f"{time.perf_counter() - t0:.1f} s")
    dist = write_bench_dtrans_cfg(os.path.join(tmp, "assets"))
    save = os.path.join(tmp, "kaldi_cli")
    argv = ["--synthetic", "--fe_cfg", PASEP_CFG, "--net_cfg", net_cfg,
            "--batch_size", str(TRAIN_BATCH), "--chunk_size",
            str(TRAIN_CHUNK), "--epoch", "1", "--compute_dtype", "bfloat16",
            "--dtrans_cfg", dist, "--stats", stats, "--save_path", save]
    tr, launches, perf, last = _cli_run(argv, "PASE+ / workers+ with the "
                                        "Kaldi heads", save)
    check({"kaldimfcc", "kaldiplp"} <= set(last),
          f"the CLI logged no Kaldi loss: {sorted(last)}")
    print(f"[kaldi] the Kaldi heads' losses at step {last['step']}: "
          f"kaldimfcc {last['kaldimfcc']:.4f}, kaldiplp "
          f"{last['kaldiplp']:.4f}; K2 (qrnn_pool_fwd_train, qrnn_pool_bwd) "
          f"{launches['qrnn_pool_fwd_train']}, {launches['qrnn_pool_bwd']} "
          f"launches at [96,200,512], K1's eval route "
          f"({k1_eval(TRAIN_SHAPE)}) {launches[k1_eval(TRAIN_SHAPE)]} in "
          f"the eval")
    del tr
    torch.cuda.empty_cache()
    errs = _kaldi_targets_card_vs_cpu()
    print(f"[kaldi] the Kaldi targets of one clean 32 x 32000 batch, card "
          f"against CPU, max|diff| / max|cpu|: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {KALDI_REL:g})")
    check(all(v <= KALDI_REL for v in errs.values()),
          f"Kaldi targets card vs CPU {errs}")
    # the step against phase 8's bench step, in turns in this process
    dcfg, assets = bench.bench_assets(TRAIN_CHUNK)
    bench_stats = compute_stats(SyntheticChunkBatcher(8, TRAIN_CHUNK,
                                                      seed=11),
                                parse_workers_cfg(WORKERSP_CFG),
                                max_batches=2, device="cuda")
    cfg = dict(backprop_mode="base", hop=160, bpe=100, epoch=400,
               batch_size=TRAIN_BATCH, chunk_size=TRAIN_CHUNK, log_freq=100,
               fe_lr=1e-3, min_lr=5e-4, lr_mode="poly",
               compute_dtype="bfloat16")
    trainers = {
        "bench": Trainer(PASEP_CFG, WORKERSP_CFG, dict(
            cfg, save_path=os.path.join(tmp, "rate_bench")),
            stats=bench_stats, dist_cfg=dcfg, dist_assets=assets,
            device="cuda"),
        "kaldi": Trainer(PASEP_CFG, net_cfg, dict(
            cfg, save_path=os.path.join(tmp, "rate_kaldi")), stats=st,
            dist_cfg=dcfg, dist_assets=assets, device="cuda")}
    batcher = DeviceSyntheticBatcher(TRAIN_BATCH, TRAIN_CHUNK, seed=24)
    batches = [batcher.make_batch() for _ in range(5)]
    rates = {k: [] for k in trainers}
    for _ in range(STEP_RATE_ROUNDS):
        for k, tr in trainers.items():
            rates[k].append(_timed_steps(tr, batches, warm=1)[0])
    ratio = [a / b for a, b in zip(rates["kaldi"], rates["bench"])]
    mean = {k: float(np.mean(v)) for k, v in rates.items()}
    print(f"[kaldi] steady-state steps/s, 32 x 32000 bf16 with the bench "
          f"stack, {STEP_RATE_ROUNDS} rounds of 4 steps after a warm one, "
          f"in turns: workers+ {mean['bench']:.3f} (rounds " + ", ".join(
              f"{r:.3f}" for r in rates["bench"]) + f"), with the Kaldi "
          f"heads {mean['kaldi']:.3f} (rounds " + ", ".join(
              f"{r:.3f}" for r in rates["kaldi"]) + f"); ratio "
          f"{np.mean(ratio):.3f}x [{min(ratio):.3f}, {max(ratio):.3f}], "
          f"spread (max - min) / mean of the Kaldi step "
          f"{(max(rates['kaldi']) - min(rates['kaldi'])) / mean['kaldi']:.3f}"
          f"; ms per step {1e3 / mean['kaldi']:.2f} against "
          f"{1e3 / mean['bench']:.2f}; the CLI epoch's own rate "
          f"{perf['steps_per_sec']:.3f} = {perf['steps_per_sec'] / bf16_rate:.3f}"
          f" x phase 8's bench rate ({bf16_rate:.3f})")
    profs = {}
    for k, tr in trainers.items():
        if k == "kaldi":
            reset_launches()              # the profiled Kaldi steps start
        profs[k] = phase_profile(tr, f"the {k} step")
    step_launches = read_launches()       # ... and end here
    layers = qrnn_layers(trainers["kaldi"].model.frontend)
    steps = 5                             # phase_profile's batches
    expected = {**{k: 0 for k in step_launches},
                "qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps}
    check(step_launches == expected,
          f"Kaldi step launches {step_launches} != {expected}")
    prep = {k: sum(p["split"].get("pase.prepare", {}).values())
            for k, p in profs.items()}
    n_launch = {k: sum(p["launches"].values()) for k, p in profs.items()}
    n_prep = {k: p["launches"].get("pase.prepare", 0)
              for k, p in profs.items()}
    print(f"[kaldi] pase.prepare device ms per step: with the Kaldi heads "
          f"{prep['kaldi']:.2f}, without {prep['bench']:.2f} (+"
          f"{prep['kaldi'] - prep['bench']:.2f}); device activities per "
          f"step: {n_launch['kaldi']:.0f} against {n_launch['bench']:.0f} "
          f"(pase.prepare {n_prep['kaldi']:.0f} against "
          f"{n_prep['bench']:.0f}); busy {profs['kaldi']['busy_ms']:.2f} "
          f"against {profs['bench']['busy_ms']:.2f} ms, idle share "
          f"{profs['kaldi']['idle_share']:.3f} against "
          f"{profs['bench']['idle_share']:.3f}")
    del trainers
    torch.cuda.empty_cache()
    return ({"kaldi_cli": launches, "kaldi_step": step_launches}, save,
            stats, net_cfg, dist)


def _tool(argv, what, audio_s=None, utts=None, layers=None):
    """One util_scripts subcommand on the card, its K1 launches counted
    from 0 (the unseeded route of a B = 1 call of 200 frames, the few-lane
    kernel, once per QRNN layer per utterance where ``utts`` is given, no
    kernel otherwise). Returns (result, launches)."""
    import torch
    from pase_tpu_torch import util_scripts
    reset_launches()                          # the tool starts here
    t0 = time.perf_counter()
    out = util_scripts.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()                # ... and ends here
    sec = time.perf_counter() - t0
    expected = {k: 0 for k in launches}
    entry = k1_eval((1, 200, 512))
    if utts is not None:
        expected[entry] = layers * utts
    check(launches == expected, f"{what} launches {launches} != {expected}")
    print(f"[tools24] python -m pase_tpu_torch.util_scripts {argv[0]}: "
          f"{sec:.2f} s" + (f", {audio_s / sec:.1f} audio-s/s"
                            if audio_s else "")
          + f"; K1 launches {launches.get(entry, 0)} {entry} ({what})")
    return out, launches


def _kmeans_lockstep(xc, xg, init):
    """util_scripts.kmeans's Lloyd steps side by side on the CPU's rows
    ``xc`` [N, D] and on ``xg``, the same rows on another device (or with
    their columns in another order), from the rows ``init``: at each step
    a row the two assign otherwise must be a rounding tie (its two
    centres, the CPU's, within KMEANS_TIE_REL (|x|^2 + |c|^2) of each
    other in float64), and there the CPU takes the other side's centre, so
    that the two runs stay together. Returns (the other side's last
    assignments, row-steps forced at ties, row-steps differing outside
    ties)."""
    import torch
    from pase_tpu_torch import util_scripts as U
    idx = torch.as_tensor(np.array(init))
    cc, cg = xc[idx], xg[idx.to(xg.device)]
    sqc, sqg = (torch.sum(v ** 2, 1)[:, None] for v in (xc, xg))
    x64 = xc.double()
    ties = outside = 0
    for _ in range(KMEANS_ITERS):
        ag = U.kmeans_assign(xg, cg, sqg).cpu()
        ac = U.kmeans_assign(xc, cc, sqc)
        rows = torch.nonzero(ag != ac)[:, 0]
        if len(rows):
            c64 = cc.double()
            d = [torch.sum((x64[rows] - c64[a[rows]]) ** 2, 1)
                 for a in (ag, ac)]
            scale = (torch.sum(x64[rows] ** 2, 1)
                     + torch.sum(c64[ac[rows]] ** 2, 1))
            tie = torch.abs(d[0] - d[1]) <= KMEANS_TIE_REL * scale
            ties += int(tie.sum())
            outside += int((~tie).sum())
            ac = ag.clone()
        cg = U.kmeans_means(xg, ag.to(xg.device), cg)
        cc = U.kmeans_means(xc, ac, cc)
    return ag.numpy(), ties, outside


def _tools24(tmp, save, stats, net_cfg, dist):
    """Phase 24 (b): the other util_scripts tools at PASE+ width on a
    seeded corpus of TOOL_UTTS utterances of TOOL_SECONDS: clusterize
    (k TOOL_K, (a)'s encoder) held to the CPU's KMeans of the same
    features from the same initial rows, project-features, prosodic-eval
    with (a)'s checkpoint and statistics, make-fbanks, vadproc,
    make-contaminated with the bench stack, select-ckpt. Returns the
    paths."""
    import glob
    import torch
    from pase_tpu_torch import util_scripts
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
    wav_root, data_cfg = write_synthetic_corpus(
        os.path.join(tmp, "corpus"), TOOL_UTTS * TOOL_SECONDS, 4.0, seed=24,
        min_seconds=TOOL_SECONDS, max_seconds=TOOL_SECONDS)
    with open(data_cfg) as f:
        names = [e["filename"] for e in json.load(f)["train"]["data"]]
    lst = os.path.join(tmp, "wavs.lst")
    with open(lst, "w") as f:
        f.write("\n".join(names) + "\n")
    audio_s = len(names) * TOOL_SECONDS
    with open(PASEP_CFG) as f:
        layers = json.load(f).get("rnn_layers", 1)
    fe_ckpt = os.path.join(save, "FE_e0.npz")
    enc = ["--fe_cfg", PASEP_CFG, "--fe_ckpt", fe_ckpt, "--wav_list", lst,
           "--data_root", wav_root]
    paths = {}
    clusters = os.path.join(tmp, "clusters.npz")
    (centers, assign), paths["clusterize"] = _tool(
        ["clusterize", *enc, "--k", str(TOOL_K), "--out_file", clusters],
        "clusterize", audio_s, len(names), layers)
    x = util_scripts._frame_features(util_scripts.build_parser().parse_args(
        ["clusterize", *enc]))
    init = util_scripts.kmeans_init(len(x), TOOL_K)
    _, cpu_assign = util_scripts.kmeans(torch.from_numpy(x), TOOL_K,
                                        iters=KMEANS_ITERS, init_idx=init)
    flips = int((cpu_assign != assign).sum())
    replay, ties, outside = _kmeans_lockstep(
        torch.from_numpy(x), torch.from_numpy(x).to("cuda"), init)
    print(f"[tools24] clusterize: {len(x)} frames of {len(names)} "
          f"utterances, k {TOOL_K}, "
          f"{int((np.bincount(assign, minlength=TOOL_K) > 0).sum())} clusters"
          f" used; the CPU's KMeans of the same features from the same "
          f"initial rows: {flips} frames assigned otherwise "
          f"({flips / len(x):.4%}; {KMEANS_ITERS} Lloyd steps amplify "
          f"rounding); replayed step by step from shared centres: {ties} "
          f"frame-steps differ at rounding ties (within "
          f"{KMEANS_TIE_REL:g} (|x|^2 + |c|^2) in float64; the CPU takes "
          f"the card's centre there), {outside} outside ties; the card's "
          f"replay equals clusterize's assignments: "
          f"{np.array_equal(replay, assign)}")
    check(centers.shape == (TOOL_K, x.shape[1]) and np.isfinite(
        centers).all() and outside == 0 and np.array_equal(replay, assign),
          f"clusterize: {outside} card-vs-CPU differences outside rounding "
          f"ties; the replay differs from clusterize on "
          f"{int((replay != assign).sum())} frames")
    proj_file = os.path.join(tmp, "proj.npy")
    (proj, w), paths["project_features"] = _tool(
        ["project-features", *enc, "--out_file", proj_file],
        "project-features", audio_s, len(names), layers)
    check(proj.shape == (len(x), 2) and np.isfinite(proj).all()
          and w[-1] > w[-2] > 0, f"project-features {proj.shape}")
    ckpt = sorted(glob.glob(os.path.join(save, "weights_PASE-*.npz")))[-1]
    pe_out = os.path.join(tmp, "prosody.json")
    res, paths["prosodic_eval"] = _tool(
        ["prosodic-eval", "--fe_cfg", PASEP_CFG, "--net_cfg", net_cfg,
         "--ckpt", ckpt, "--wav_list", lst, "--data_root", wav_root,
         "--stats", stats, "--out_file", pe_out], "prosodic-eval",
        audio_s, len(names), layers)
    check(res["n_utts"] == len(names) and all(
        np.isfinite(v) for v in res.values()), f"prosodic-eval {res}")
    print(f"[tools24] prosodic-eval of {os.path.basename(ckpt)}: "
          f"{json.dumps(res)}")
    fb = os.path.join(tmp, "fbanks")
    n, _ = _tool(["make-fbanks", "--wav_list", lst, "--data_root", wav_root,
                  "--out_dir", fb], "make-fbanks", audio_s)
    shapes = {np.load(os.path.join(fb, f)).shape for f in os.listdir(fb)}
    check(n == len(names) and shapes == {(int(TOOL_SECONDS * SR) // 160,
                                          120)},
          f"make-fbanks {n} files of {shapes}")
    vad = os.path.join(tmp, "vad")
    n, _ = _tool(["vadproc", "--wav_list", lst, "--data_root", wav_root,
                  "--out_dir", vad], "vadproc (host)", audio_s)
    regions = sum(len(open(os.path.join(vad, f)).read().split("\n")) - 1
                  for f in os.listdir(vad))
    check(n == len(names) and regions >= len(names),
          f"vadproc: {regions} regions in {n} files")
    dirty = os.path.join(tmp, "dirty")
    n, _ = _tool(["make-contaminated", "--wav_list", lst, "--data_root",
                  wav_root, "--out_dir", dirty, "--dtrans_cfg", dist,
                  "--chunk_size", str(TRAIN_CHUNK)],
                 "make-contaminated, the bench stack", audio_s)
    from pase_tpu_torch.data.io import read_wav
    changed = sum(not np.array_equal(read_wav(os.path.join(dirty, os.path.basename(
        p)))[0], read_wav(os.path.join(wav_root, p))[0]) for p in names)
    check(n == len(names) and changed > 0,
          f"make-contaminated: {changed} of {n} files changed")
    for i, v in enumerate((res["uv_acc"], 0.5, None)):
        with open(os.path.join(tmp, f"probe{i}.json"), "w") as f:
            json.dump({} if v is None else {"uv_acc": v}, f)
    best, _ = _tool(["select-ckpt", "--metrics_glob",
                     os.path.join(tmp, "probe*.json"), "--metric", "uv_acc"],
                    "select-ckpt (host)")
    check(best["uv_acc"] == max(res["uv_acc"], 0.5), f"select-ckpt {best}")
    print(f"[tools24] {len(names)} utterances of {TOOL_SECONDS:g} s: "
          f"vadproc {regions} regions; make-contaminated changed {changed} "
          f"of {n} files; select-ckpt {json.dumps(best)}")
    return paths


def _builders24(tmp):
    """Phase 24 (c): data_prep segment, iemocap-segment then probe-lists
    (--class_from dirname, a session held out) and chime5-cfg on seeded
    trees; the files they write checked."""
    from pase_tpu_torch import data_prep
    from pase_tpu_torch.data import synthetic_corpus as S
    t0 = time.perf_counter()
    long_wavs = S.write_synthetic_long_wavs(os.path.join(tmp, "long"), 3,
                                            40.0, seed=24)
    seg = os.path.join(tmp, "seg")
    data_prep.main(["segment", "--data_root", os.path.join(tmp, "long"),
                    "--out_root", seg])
    n_seg = len(os.listdir(seg))
    check(n_seg >= 2 * len(long_wavs) and all(
        f.rsplit("-", 1)[0] + ".wav" in long_wavs for f in os.listdir(seg)),
          f"segment wrote {sorted(os.listdir(seg))}")
    emo = os.path.join(tmp, "emo")
    data_prep.main(["iemocap-segment", "--iemocap_root",
                    S.write_synthetic_iemocap(os.path.join(tmp, "iemocap"),
                                              seed=24), "--out_dir", emo])
    lists = os.path.join(tmp, "lists")
    data_prep.main(["probe-lists", "--data_root", emo, "--class_from",
                    "dirname", "--holdout", "session2", "--out_dir", lists])
    with open(os.path.join(lists, "te.lst")) as f:
        te = f.read().split()
    check(sorted(os.listdir(lists)) == ["class_map.json", "te.lst", "tr.lst",
                                        "utt2class.json"]
          and te and all(w.startswith("session2") for w in te[::2]),
          f"probe-lists wrote {os.listdir(lists)}")
    worn, array = S.write_synthetic_chime5(os.path.join(tmp, "chime5"),
                                           seed=24)
    c5 = os.path.join(tmp, "chime5_seg")
    data_prep.main(["chime5-cfg", "--ihm_dir", worn, "--sdm_dir", array,
                    "--out_dir", c5, "--cfg_file",
                    os.path.join(tmp, "chime5.cfg")])
    with open(os.path.join(tmp, "chime5.cfg")) as f:
        cfg = json.load(f)
    entries = [e for s in ("train", "valid", "test") for e in cfg[s]["data"]]
    check(entries and len(os.listdir(c5)) == 2 * len(entries) and all(
        os.path.exists(os.path.join(c5, e[k])) for e in entries
        for k in ("filename", "1")), f"chime5-cfg wrote {len(entries)} pairs")
    print(f"[builders] data_prep segment ({n_seg} segments of 3 seeded 40 s "
          f"recordings), iemocap-segment + probe-lists --holdout session2 "
          f"({len(te) // 2} test utterances), chime5-cfg ({len(entries)} "
          f"worn / array pairs cut): {time.perf_counter() - t0:.1f} s on "
          f"Python {sys.version.split()[0]}")


def phase_kaldi(tmp, bf16_rate):
    """Phase 24: the Kaldi MFCC / PLP worker targets trained at full width,
    the other util_scripts tools and the other corpus builders."""
    t0 = time.perf_counter()
    paths, save, stats, net_cfg, dist = _kaldi_step(tmp, bf16_rate)
    paths.update(_tools24(tmp, save, stats, net_cfg, dist))
    _builders24(os.path.join(tmp, "builders"))
    print(f"[kaldi] phase 24 in {time.perf_counter() - t0:.1f} s")
    return paths


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# the processes this script started and has not joined yet: main() ends
# any still running when a phase fails
_CHILDREN = []
# the process groups of the children that start processes of their own
_GROUPS = []


def _end_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for pgid in _GROUPS:
        _end_group(pgid)


def _background(argv, log, env=None, threads=CHILD_THREADS):
    """``python3 chip_smoke.py ARGV`` in a session of its own (the
    processes it starts end with it), its output to ``log``, its CPU ops
    on ``threads`` threads: it shares the host's cores with this process
    and the other children. ``_background_join`` waits for it."""
    env = dict(env or os.environ, OMP_NUM_THREADS=str(threads))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv], cwd=HERE,
            env=env, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
    _CHILDREN.append(proc)
    _GROUPS.append(proc.pid)
    return proc, log


def _background_join(started, what, timeout):
    """The output of a ``_background`` process, which must exit 0 within
    ``timeout`` s of this call."""
    proc, log = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _end_group(proc.pid)
        proc.wait()
    with open(log) as f:
        text = f.read()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}: "
          f"{text[-3000:]}")
    return text


def _ranks(mode, spec, tmp, world=DP_RANKS):
    """``world`` processes of this script in ``mode`` (--dp-step: the
    trainer's step; --cli-rank: the training CLI), gloo ranks on the one
    card, joined on a free loopback port. A rank that exits non-zero or
    outlives DP_TIMEOUT fails the phase. Returns [(its result, its
    output)] in rank order."""
    return _join_ranks(_start_ranks(mode, spec, tmp, world))


def _start_ranks(mode, spec, tmp, world=DP_RANKS):
    """``_ranks``'s processes, started; ``_join_ranks`` waits for them."""
    import pickle
    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    port = str(_free_port())
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
    env = dict(os.environ, PASE_TORCH_DIST_BACKEND="gloo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, spec_path, str(r),
         str(world), port, outs[r]], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    _CHILDREN.extend(procs)
    return mode, procs, outs


def _join_ranks(started):
    """[(result, output)] of ``_start_ranks``'s processes, in rank
    order."""
    import pickle
    mode, procs, outs = started
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=DP_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        tails = []
        for p in procs:
            p.kill()
            tails.append(p.communicate()[0][-1500:])
        check(False, f"{mode}: a rank did not finish in {DP_TIMEOUT} s: "
              + " | ".join(tails))
    for r, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"{mode} rank {r} exited {p.returncode}: "
              f"{text[-3000:]}")
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return list(zip(results, texts))


def _dp_cfg(tmp):
    return dict(backprop_mode="base", hop=160, bpe=100, epoch=1,
                batch_size=TRAIN_BATCH, chunk_size=TRAIN_CHUNK, fe_lr=1e-4,
                min_lr=4e-4, lr_mode="step", random_scale=True,
                save_path=tmp)


def _dp_batches(batch=TRAIN_BATCH):
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    it = iter(SyntheticChunkBatcher(batch, TRAIN_CHUNK, seed=0))
    return [next(it) for _ in range(2)]


def dp_child(mode, spec_path, rank, world, port, out):
    """A rank of phases 25-27: --dp-step runs the trainer's two steps on
    its rows (recording its PReLU signs, its step-1 gradient, gathered
    whole under the cfg's n_model, on rank 0, its losses and step ms),
    then ``spec['rate_steps']`` timed bf16 steps after one warm-up, and
    gives its parameter and Adam bytes; --cli-rank runs the training CLI.
    Each returns its launch counts."""
    import pickle
    import torch
    from pase_tpu_torch.precision import full_precision
    full_precision()
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    reset_launches()
    if mode == "--cli-rank":
        from pase_tpu_torch import train as train_cli
        train_cli.SYNTHETIC_BPE = spec.get("steps", CLI_STEPS)
        tr = train_cli.main(spec["argv"] + [
            "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", str(world), "--process_id", str(rank)])
        torch.cuda.synchronize()
        result = {"bpe": tr.bpe, "va_bpe": tr.cfg["va_bpe"],
                  "layers": len(tr.model.frontend.rnn.layers)}
    else:
        import torch.distributed as dist
        from pase_tpu_torch.grad_parity import prelu_signs
        from pase_tpu_torch.parallel import tp
        from pase_tpu_torch.parallel.mesh import (host_batch_slice,
                                                  init_distributed)
        from pase_tpu_torch.precision import resolve
        from pase_tpu_torch.trainer import Trainer
        assert init_distributed(f"127.0.0.1:{port}", world, rank,
                                device="cuda", backend="gloo")
        tr = Trainer(PASEP_CFG, WORKERSP_CFG, spec["cfg"], device="cuda")
        sl = host_batch_slice(spec["cfg"]["batch_size"])
        losses, ms, record, running = [], [], {}, {}
        for i, raw in enumerate(spec["batches"]):
            local = {k: v[sl] for k, v in raw.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with prelu_signs(tr.model, record=record if i == 0 else None):
                out_i = tr.train_step(local)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append({k: float(v) for k, v in out_i.items()})
            if i == 0:
                # an attention block's scoring MLP has no gradient: zeros;
                # the leaves held as parts gathered whole (every rank)
                specs, grads = tp.leaf_specs(tr.model), None
                if rank == 0 or specs:
                    grads = tp.full_tensors(_grads(tr.model), specs)
                grads = grads if rank == 0 else None
                running = {k: b.double().cpu() for k, b in
                           tr.model.named_buffers()
                           if k.endswith("running_dist")}
        rate_ms = []
        if spec.get("rate_steps"):
            tr.compute_dtype = resolve("bfloat16")
            for i in range(spec["rate_steps"] + 1):
                local = {k: v[sl] for k, v in
                         spec["batches"][i % len(spec["batches"])].items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_step(local)
                torch.cuda.synchronize()
                rate_ms.append(1e3 * (time.perf_counter() - t0))
        result = {"losses": losses, "ms": ms, "grads": grads,
                  "running": running, "rate_ms": rate_ms[1:],
                  "bytes": _state_bytes(tr),
                  "signs": {k: (np.packbits((x > 0).numpy()), tuple(x.shape))
                            for k, x in record.items()}}
        dist.destroy_process_group()
    result["launches"] = read_launches()
    with open(out, "wb") as f:
        pickle.dump(result, f)
    return 0


def _global_signs(ranks, batch=TRAIN_BATCH, n_model=1, channels=None):
    """The one-process PReLU masks of the ranks' signs: a module's input
    holds k blocks of each data rank's rows side by side (the encoder's
    chunk, ctxt and rand; a MI head's positives and negatives), put back
    in the global batch's order; on a grid of ``n_model`` model ranks a
    column-parallel module's input is its rank's channels (axis 1; fewer
    than the one process's ``channels[name]``), put side by side, a
    replicated one's is whole on each."""
    import torch
    per = batch // (len(ranks) // n_model)
    masks = {}
    for name in ranks[0]["signs"]:
        parts = []
        for d in range(len(ranks) // n_model):
            group = []
            for res in ranks[d * n_model:(d + 1) * n_model]:
                bits, shape = res["signs"][name]
                n = int(np.prod(shape))
                group.append(np.unpackbits(bits)[:n].astype(bool).reshape(
                    shape))
            column = n_model > 1 and group[0].shape[1] != channels[name]
            parts.append(np.concatenate(group, 1) if column else group[0])
        k = parts[0].shape[0] // per
        masks[name] = torch.from_numpy(np.concatenate(
            [p[s * per:(s + 1) * per] for s in range(k) for p in parts]))
    return masks


def _dp_step(tmp):
    """(a): two gloo ranks on the card, each 16 of the 32 x 32000 rows,
    two steps; against the one-process step on the card."""
    print("[data-parallel] (a) a rank's " + k2_route(
        (3 * TRAIN_BATCH // DP_RANKS, TRAIN_CHUNK // 160, 512)))
    return _dp_compare(tmp, _dp_cfg(os.path.join(tmp, "ranks")),
                       _dp_batches(), "(a) data-parallel step", "dp_step")[0]


def _one_process(tmp, cfg, batches, rate_steps=0, n_models=()):
    """The one-process step on the card that phases 25-27 hold their ranks
    to: two steps of PASE+ / workers+ under ``cfg`` on ``batches`` (the
    PReLU inputs of step 1 recorded), then with ``rate_steps`` that many
    timed bf16 steps after one warm-up; {'losses', 'ms', 'x', 'grads' (step
    1's), 'running', 'names', 'layers', 'rate_ms', 'bytes', 'want_bytes'
    ({n_model: a rank's parameter bytes: a leaf the rule shards 1 /
    n_model, a replicated one whole})}."""
    import torch
    from pase_tpu_torch.grad_parity import prelu_signs
    from pase_tpu_torch.parallel import tp
    from pase_tpu_torch.precision import resolve
    from pase_tpu_torch.trainer import Trainer
    one = Trainer(PASEP_CFG, WORKERSP_CFG, dict(
        cfg, n_model=1, save_path=os.path.join(tmp, "one")), device="cuda")
    ref = {"x": {}, "losses": [], "ms": [], "rate_ms": [],
           "names": one.ordered_names,
           "layers": len(one.model.frontend.rnn.layers)}
    for i, raw in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prelu_signs(one.model, record=ref["x"] if i == 0 else None):
            out = one.train_step(raw)
        torch.cuda.synchronize()
        ref["ms"].append(1e3 * (time.perf_counter() - t0))
        ref["losses"].append({k: float(v) for k, v in out.items()})
        if i == 0:
            ref["grads"] = _grads(one.model)
            ref["running"] = {k: b.double().cpu() for k, b in
                              one.model.named_buffers()
                              if k.endswith("running_dist")}
    if rate_steps:
        one.compute_dtype = resolve("bfloat16")
        for i in range(rate_steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.train_step(batches[i % len(batches)])
            torch.cuda.synchronize()
            ref["rate_ms"].append(1e3 * (time.perf_counter() - t0))
        ref["rate_ms"] = ref["rate_ms"][1:]
    ref["bytes"] = _state_bytes(one)
    ref["want_bytes"] = {}
    for n in n_models:
        sharded = tp.rule_sharded(one.model, n)
        ref["want_bytes"][n] = sum(
            p.numel() * p.element_size() // (n if k in sharded else 1)
            for k, p in one.model.named_parameters())
    del one
    torch.cuda.empty_cache()
    return ref


def _dp_spec(cfg, batches, rate_steps=0):
    return {"cfg": cfg, "batches": batches, "rate_steps": rate_steps}


def _dp_compare(tmp, cfg, batches, what, path, world=DP_RANKS,
                rate_steps=0, ref=None, joined=None):
    """``world`` gloo ranks on the card (a grid of cfg['n_model'] model
    ranks, default 1: each data rank its share of the rows of
    ``batches``, cfg['batch_size'] rows each), two steps of PASE+ /
    workers+ under ``cfg``; against the one-process step on the card:
    per-worker losses, every rank's losses bit for bit, rank 0's
    all-reduced (and gathered) step-1 gradient with the one process's
    PReLUs on the ranks' side of the kink, any attention block's
    running_dist after step 1 (1e-6). With ``rate_steps`` each rank then
    times that many bf16 steps after one warm-up. ``ref``: the one
    process's run (``_one_process``), made here when None; ``joined``:
    the ranks' (result, output) when the caller ran them
    (``_start_ranks`` of ``_dp_spec``). Returns (the ranks' summed
    launches, the ranks' results)."""
    import torch
    from pase_tpu_torch.grad_parity import (group_errors, prelu_signs,
                                            worst_leaves)
    from pase_tpu_torch.trainer import Trainer
    batch = cfg["batch_size"]
    n_model = cfg.get("n_model", 1)
    if joined is None:
        joined = _ranks("--dp-step", _dp_spec(cfg, batches, rate_steps),
                        os.path.join(tmp, "ranks"), world)
    ranks = [r for r, _ in joined]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    if ref is None:
        ref = _one_process(tmp, cfg, batches)
    x_one, one_losses, one_ms = ref["x"], ref["losses"], ref["ms"]
    natural, running = ref["grads"], ref["running"]
    signed = Trainer(PASEP_CFG, WORKERSP_CFG, dict(
        cfg, n_model=1, save_path=os.path.join(tmp, "signed")),
        device="cuda")
    masks = _global_signs(ranks, batch, n_model,
                          {k: x.shape[1] for k, x in x_one.items()})
    with prelu_signs(signed.model, force=masks):
        signed.train_step(batches[0])
    g_dp = ranks[0]["grads"]
    flips = {}
    for k, x in x_one.items():
        flip = masks[k] != (x > 0)
        if flip.any():
            flips[k] = (int(flip.sum()),
                        (x.abs()[flip].max() / x.abs().max()).item())
    far = max([r for _, r in flips.values()], default=0.0)
    nat_err = group_errors(g_dp, natural)
    grad_err = group_errors(g_dp, _grads(signed.model))
    worst = worst_leaves(g_dp, _grads(signed.model), n=3)
    n_steps = len(batches)
    loss_err = [{k: abs(ranks[0]["losses"][i][k] - one_losses[i][k])
                 / abs(one_losses[i][k]) for k in ref["names"]}
                for i in range(n_steps)]
    same = all(r["losses"][i] == ranks[0]["losses"][i]
               for r in ranks[1:] for i in range(n_steps))
    run_err = max([(r["running"][k] - v).abs().max().item()
                   for r in ranks for k, v in running.items()], default=0.0)
    check(all(set(r["running"]) == set(running) for r in ranks),
          f"{what}: running_dist buffers differ")
    grid = (f"a {world // n_model} x {n_model} grid of " if n_model > 1
            else "")
    print(f"[parallel] {what}, {grid}{world} gloo ranks on one card "
          f"(PASE+, workers+{', ' + os.path.relpath(cfg['att_cfg'], HERE) if cfg.get('att_cfg') else ''}, "
          f"global batch {batch} x {TRAIN_CHUNK}, "
          f"float32, TF32 off, random_scale): step ms "
          + ", ".join(f"rank {i} " + ", ".join(f"{t:.1f}" for t in r["ms"])
                      for i, r in enumerate(ranks)) + "; one process "
          f"{', '.join(f'{t:.1f}' for t in one_ms)} (first steps, no "
          f"bound); per-worker |loss_dp - loss_one| / |loss_one|, step 1: "
          + ", ".join(f"{k} {v:.2e}" for k, v in loss_err[0].items())
          + f" (bound {TRAIN_LOSS_REL})"
          + (f"; step 2 max {max(loss_err[1].values()):.2e} (bound "
             f"{DP_STEP2_REL})" if n_steps > 1 else "")
          + f"; the ranks' losses bit for bit equal: {same}"
          + (f"; {len(running)} running_dist buffers after step 1, max "
             f"|ranks - one process| {run_err:.2e} (bound "
             f"{DP_RUNNING_ATOL})" if running else ""))
    print(f"[parallel] {what}: PReLU inputs of opposite sign in the ranks "
          f"and in one process: {sum(n for n, _ in flips.values())} in "
          f"{len(flips)} PReLU(s), the largest |x| {far:.2e} of its "
          f"module's max (bound {FLIP_REL}); rank 0's all-reduced step-1 "
          f"gradient, max|g_dp - g_one| / max|g_one| per group: "
          + ", ".join(f"{g} {v:.2e}" for g, v in nat_err.items())
          + "; with the ranks' PReLU sides: "
          + ", ".join(f"{g} {v:.2e}" for g, v in grad_err.items())
          + f" (bound {TRAIN_GRAD_REL}); worst leaves: " + "; ".join(
              f"{k} {a:.2e} of its max" for k, a, _, _ in worst))
    check(same, f"{what}: the ranks' losses differ")
    check(all(v <= TRAIN_LOSS_REL for v in loss_err[0].values()),
          f"{what} step 1 losses beyond {TRAIN_LOSS_REL}: {loss_err[0]}")
    step2 = loss_err[1] if n_steps > 1 else {}
    check(all(v <= DP_STEP2_REL for v in step2.values()),
          f"{what} step 2 losses beyond {DP_STEP2_REL}: {step2}")
    check(far <= FLIP_REL, f"{what}: a PReLU input {far:.3e} of its "
          f"module's max from 0 has opposite signs in the ranks and one "
          f"process")
    check(all(v <= TRAIN_GRAD_REL for v in grad_err.values()),
          f"{what} gradients beyond {TRAIN_GRAD_REL}: {grad_err}")
    check(run_err <= DP_RUNNING_ATOL,
          f"{what}: running_dist {run_err:.3e} from one process's")
    layers = ref["layers"]
    steps = n_steps + (rate_steps + 1 if rate_steps else 0)
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": world * steps * layers,
                "qrnn_pool_bwd": world * steps * layers}
    print(f"[launches] {path}: {launches} (expected {expected}: "
          f"{world} ranks x {steps} steps x {layers} QRNN layer(s))")
    check(launches == expected, f"{path} launches {launches} != "
          f"{expected}")
    del signed
    torch.cuda.empty_cache()
    return launches, ranks


def _dp_cli(tmp):
    """(b): the training CLI with the three flags, one NCCL process."""
    import math
    import torch
    from pase_tpu_torch import train as train_cli
    reset_launches()
    t0 = time.perf_counter()
    tr = train_cli.main([
        "--synthetic", "--net_cfg", WORKERSP_CFG, "--fe_cfg", PASEP_CFG,
        "--batch_size", str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK),
        "--compute_dtype", "bfloat16", "--epoch", "1", "--log_freq", "5",
        "--save_path", tmp, "--coordinator_address",
        f"127.0.0.1:{_free_port()}", "--num_processes", "1",
        "--process_id", "0"])
    torch.cuda.synchronize()
    launches = read_launches()
    wall = time.perf_counter() - t0
    check(not torch.distributed.is_initialized(),
          "the CLI left its process group up")
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    vals = [v for r in recs if r["split"] in ("train", "eval")
            for k, v in r.items() if k not in ("t", "split", "step")]
    check(vals and all(math.isfinite(v) for v in vals),
          "dp_cli: a logged loss is not finite")
    check(os.path.isfile(os.path.join(tmp, "FE_e0.npz")),
          "dp_cli: FE_e0.npz was not written")
    layers = len(tr.model.frontend.rnn.layers)
    steps, evals = tr.bpe, tr.cfg["va_bpe"]
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps,
                k1_eval(TRAIN_SHAPE): layers * evals}
    perf = [r for r in recs if r["split"] == "perf"][0]
    print(f"[parallel] (b) python -m pase_tpu_torch.train --synthetic "
          f"--coordinator_address --num_processes 1 --process_id 0 (NCCL; "
          f"{TRAIN_BATCH} x {TRAIN_CHUNK}, bf16, {steps} steps + {evals} "
          f"eval): {wall:.1f} s, {perf['steps_per_sec']:.3f} steps/s; "
          f"FE_e0.npz written, every logged loss finite")
    print(f"[launches] dp_cli: {launches} (expected {expected})")
    check(launches == expected, f"dp_cli launches {launches} != {expected}")
    return launches


def _sharded_corpus(tmp):
    """(c): two gloo CLI ranks with --device_corpus --shard_device_corpus
    on a seeded corpus."""
    from pase_tpu_torch.data.io import wav_len
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
    wav_root, data_cfg = write_synthetic_corpus(
        os.path.join(tmp, "corpus"), *SHARD_CORPUS_S, seed=25,
        utts_per_chapter=4, min_seconds=2.0, max_seconds=12.0)
    with open(data_cfg) as f:
        train_files = [e["filename"] for e in json.load(f)["train"]["data"]]
    groups = {f.rsplit("-", 1)[0] for f in train_files}
    check(len(groups) >= 8, f"the corpus has {len(groups)} prefix groups")
    corpus_bytes = sum(2 * max(wav_len(os.path.join(wav_root, f)),
                               TRAIN_CHUNK) for f in train_files)
    save = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    ranks = _ranks("--cli-rank", {"argv": [
        "--data_root", wav_root, "--data_cfg", data_cfg, "--net_cfg",
        WORKERSP_CFG, "--fe_cfg", PASEP_CFG, "--batch_size",
        str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK),
        "--compute_dtype", "bfloat16", "--epoch", "1", "--log_freq", "1",
        "--device_corpus", "--shard_device_corpus", "--save_path", save]},
        os.path.join(tmp, "ranks"))
    wall = time.perf_counter() - t0
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows0 = [json.loads(line) for line in f if line.strip()]
    tag = "[rank 1] "
    rows1 = [json.loads(line[len(tag):]) for line in ranks[1][1].splitlines()
             if line.startswith(tag)]

    def strip(rows, splits=("train", "eval")):
        return [{k: v for k, v in r.items() if k != "t"} for r in rows
                if r["split"] in splits]

    feeds = [int(r["corpus_bytes"]) for r in rows0 + rows1
             if r["split"] == "feed"]
    same = strip(rows0) == strip(rows1) and len(strip(rows0)) > 0
    print(f"[parallel] (c) sharded device corpus, 2 gloo CLI ranks on one "
          f"card ({len(train_files)} utterances in {len(groups)} prefix "
          f"groups, {corpus_bytes} bytes of int16; {TRAIN_BATCH} x "
          f"{TRAIN_CHUNK}, bf16, {ranks[0][0]['bpe']} steps + "
          f"{ranks[0][0]['va_bpe']} eval): {wall:.1f} s for both "
          f"processes; bytes on the card per rank {feeds} (sum "
          f"{sum(feeds)}); the ranks' train / eval rows bit for bit "
          f"equal: {same}")
    check(len(feeds) == 2 and sum(feeds) == corpus_bytes
          and max(feeds) < corpus_bytes,
          f"the shards' bytes {feeds} do not split the corpus's "
          f"{corpus_bytes}")
    check(same, "the ranks' metrics rows differ")
    check(os.path.isfile(os.path.join(save, "FE_e0.npz")),
          "sharded corpus: FE_e0.npz was not written")
    launches = {k: sum(r["launches"][k] for r, _ in ranks)
                for k in ranks[0][0]["launches"]}
    res = ranks[0][0]
    layers = res["layers"]
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": DP_RANKS * layers * res["bpe"],
                "qrnn_pool_bwd": DP_RANKS * layers * res["bpe"],
                k1_eval((3 * TRAIN_BATCH // DP_RANKS, TRAIN_CHUNK // 160,
                         512)): DP_RANKS * layers * res["va_bpe"]}
    print(f"[launches] sharded_corpus: {launches} (expected {expected})")
    check(launches == expected, f"sharded_corpus launches {launches} != "
          f"{expected}")
    return launches


def _close_to(got, want, atol, rtol):
    """max(|got - want| - (atol + rtol |want|)) <= 0, and max|got - want|."""
    d = (got - want).abs()
    return bool((d <= atol + rtol * want.abs()).all()), float(d.max())


def _time_shard(tmp):
    """(d): the time-sharded encoder over [cuda:0] * TS_SHARDS against the
    offline forward, its gradient, and forward-chunk --time_shard."""
    import torch
    from pase_tpu_torch import wf_builder
    from pase_tpu_torch import util_scripts
    from pase_tpu_torch.data.io import write_wav
    from pase_tpu_torch.parallel.sp import (encode_time_sharded,
                                            time_sharded_apply)
    enc = wf_builder(PASEP_CFG, device="cuda")
    m = enc.module
    layers = len(m.rnn.layers)
    devices = [torch.device("cuda", 0)] * TS_SHARDS
    rng = np.random.RandomState(25)
    wav = torch.from_numpy((rng.randn(*TS_SHAPE) * 0.2).astype(
        np.float32)).cuda()
    ms = {}
    for rep in range(2):
        if rep == 1:
            reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = encode_time_sharded(enc, wav, devices)
        torch.cuda.synchronize()
        ms["sharded"] = 1e3 * (time.perf_counter() - t0)
        if rep == 1:
            fwd_launches = read_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            want = m(wav)
        torch.cuda.synchronize()
        ms["offline"] = 1e3 * (time.perf_counter() - t0)
    ok, err = _close_to(got, want, TS_TOL, TS_TOL)
    gwav = torch.from_numpy((rng.randn(*TS_GRAD_SHAPE) * 0.2).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.randn(TS_GRAD_SHAPE[0], TS_GRAD_SHAPE[1] // 160,
                                   m.output_dim).astype(np.float32)).cuda()
    params = [p for p in m.parameters()]
    reset_launches()
    g_sp = torch.autograd.grad((time_sharded_apply(m, gwav, devices)
                                * w).mean(), params, allow_unused=True)
    torch.cuda.synchronize()
    grad_launches = read_launches()
    g_off = torch.autograd.grad((m(gwav) * w).mean(), params,
                                allow_unused=True)
    g_ok, g_err = True, 0.0
    for a, b in zip(g_sp, g_off):
        if b is None:
            continue
        o, e = _close_to(a, b, TS_GRAD_ATOL, TS_GRAD_RTOL)
        g_ok, g_err = g_ok and o, max(g_err, e)
    # forward-chunk --time_shard over a 10 s file, D = the visible cards
    x = (rng.randn(160000) * 0.1).astype(np.float32)
    path = os.path.join(tmp, "ts.wav")
    os.makedirs(tmp, exist_ok=True)
    write_wav(path, x)
    reset_launches()
    util_scripts.main(["forward-chunk", "--time_shard", "--fe_cfg",
                       PASEP_CFG, "--in_wav", path, "--out_file",
                       os.path.join(tmp, "ts.npy")])
    torch.cuda.synchronize()
    cli_launches = read_launches()
    from pase_tpu_torch.data.io import read_wav
    xr, _ = read_wav(path)
    cli = torch.from_numpy(np.load(os.path.join(tmp, "ts.npy")))
    ref = enc(xr[None, None])[0].cpu()
    c_ok, c_err = _close_to(cli, ref, TS_TOL, TS_TOL)
    d_cli = torch.cuda.device_count()
    print(f"[parallel] (d) time-sharded PASE+ over {TS_SHARDS} shards on "
          f"cuda:0 at {TS_SHAPE} ({TS_SHAPE[1] // SR} s): max|sharded - "
          f"offline| {err:.2e} (atol = rtol = {TS_TOL}: {ok}); forward ms "
          f"sharded {ms['sharded']:.1f}, offline {ms['offline']:.1f} "
          f"(second calls); the gradient of a fixed linear loss at "
          f"{TS_GRAD_SHAPE}: max|g_sp - g_off| {g_err:.2e} (atol "
          f"{TS_GRAD_ATOL}, rtol {TS_GRAD_RTOL}: {g_ok}); forward-chunk "
          f"--time_shard over a 10 s file (D = {d_cli}) against the "
          f"offline forward: {c_err:.2e} ({c_ok})")
    check(ok, f"time-sharded forward beyond {TS_TOL}: {err:.3e}")
    check(g_ok, f"time-sharded gradient beyond atol {TS_GRAD_ATOL} rtol "
          f"{TS_GRAD_RTOL}: {g_err:.3e}")
    check(c_ok, f"forward-chunk --time_shard beyond {TS_TOL}: {c_err:.3e}")
    checks = (
        ("time_shard", fwd_launches,
         {k1_eval((2, 1500, 512)): (TS_SHARDS - 1) * layers,
          "qrnn_pool_fwd_seg": TS_SHARDS * layers}),
        ("time_shard_grad", grad_launches,
         {"qrnn_pool_fwd_train": (2 * TS_SHARDS - 1) * layers,
          "qrnn_pool_bwd": (2 * TS_SHARDS - 1) * layers}),
        ("time_shard_cli", cli_launches,
         {k1_eval((1, 1000, 512)): (d_cli - 1) * layers,
          "qrnn_pool_fwd_seg": d_cli * layers}))
    for name, got_l, want in checks:
        expected = {**{k: 0 for k in got_l}, **want}
        print(f"[launches] {name}: {got_l} (expected {expected})")
        check(got_l == expected, f"{name} launches {got_l} != {expected}")
    return {name: got_l for name, got_l, _ in checks}


def phase_parallel(tmp):
    """Phase 25: data parallelism, the sharded device corpus and the
    time-sharded encoder. Returns {path: launches}."""
    import torch
    paths = {"dp_step": _dp_step(os.path.join(tmp, "dp_step"))}
    torch.cuda.empty_cache()
    paths["dp_cli"] = _dp_cli(os.path.join(tmp, "dp_cli"))
    torch.cuda.empty_cache()
    paths["sharded_corpus"] = _sharded_corpus(os.path.join(tmp, "sharded"))
    paths.update(_time_shard(os.path.join(tmp, "time_shard")))
    torch.cuda.empty_cache()
    return paths


def _host_stage_cli(tmp, common, synthetic_rate):
    """(a): the training CLI on phase 12's corpus with bench.py's stack
    plus the host stage's keys, and the same command without them, in
    turns (STEP_RATE_ROUNDS rounds, 4 feed threads, bf16); the stage's
    ms a batch and the share of rows it degraded. Returns {path:
    launches} of the first round."""
    dist = common[common.index("--dtrans_cfg") + 1]
    with open(dist) as f:
        js = json.load(f)
    js.update(codec2_p=CODEC2_P, codec2_kbps=CODEC2_KBPS,
              whisper_p=WHISPER_P)
    staged_cfg = os.path.join(tmp, "bench_dist_codec2.cfg")
    os.makedirs(tmp, exist_ok=True)
    with open(staged_cfg, "w") as f:
        json.dump(js, f)
    staged = list(common)
    staged[staged.index("--dtrans_cfg") + 1] = staged_cfg
    runs = {"host stage": staged, "no host stage": common}
    rates = {k: [] for k in runs}
    waits = {k: [] for k in runs}
    paths, stats = {}, []
    for r in range(STEP_RATE_ROUNDS):
        for label, args in runs.items():
            save = os.path.join(tmp, f"{label.replace(' ', '_')}_{r}")
            tr, perf, _ = _disk_run(
                args + ["--num_workers", "4", "--epoch", "1",
                        "--save_path", save],
                f"{label}, round {r + 1}", synthetic_rate)
            launches = read_launches()          # _disk_run's, checked
            rates[label].append(perf["steps_per_sec"])
            waits[label].append(perf["feed_wait_ms"])
            if r == 0:
                paths["host_stage_cli" if label == "host stage"
                      else "host_stage_plain"] = launches
            if label == "host stage":
                with open(os.path.join(save, "metrics.jsonl")) as f:
                    recs = [json.loads(line) for line in f if line.strip()]
                hs = [x for x in recs if x["split"] == "host_stage"]
                check(len(hs) == 1, f"host stage run {r + 1}: no "
                      "host_stage line logged")
                stats.append(hs[0])
            del tr
    rows = int(sum(x["rows"] for x in stats))
    fired = int(sum(x["fired_Codec2RoundTrip"] for x in stats))
    whisper = int(sum(x["fired_Whisperize"] for x in stats))
    sd = (rows * CODEC2_P * (1 - CODEC2_P)) ** 0.5
    stage_ms = statistics.mean(x["ms_per_batch"] for x in stats)
    with_r, without_r = (statistics.median(rates[k]) for k in runs)
    print(f"[host-stage] (a) python -m pase_tpu_torch.train on phase 12's "
          f"corpus (PASE+, workers+, {TRAIN_BATCH} x {TRAIN_CHUNK}, bf16, "
          f"--num_workers 4), bench.py's stack plus codec2_p {CODEC2_P} "
          f"(codec2_kbps {CODEC2_KBPS}, the vendored vocoder) and "
          f"whisper_p {WHISPER_P} (ahocoder absent: Whisperize is "
          f"identity, {whisper} rows passed through it unchanged), "
          f"against the same command without the two keys, in turns "
          f"({STEP_RATE_ROUNDS} rounds): steps/s "
          + ", ".join(f"{v:.3f}" for v in rates["host stage"])
          + " against " + ", ".join(f"{v:.3f}"
                                    for v in rates["no host stage"])
          + f" (medians {with_r:.3f} / {without_r:.3f} = "
          f"{with_r / without_r:.3f}x); feed wait ms/step "
          + ", ".join(f"{v:.2f}" for v in waits["host stage"]) + " against "
          + ", ".join(f"{v:.2f}" for v in waits["no host stage"])
          + f"; the stage {stage_ms:.2f} ms a batch (consuming thread), "
          f"{fired} of {rows} rows through codec2 ({fired / rows:.4f}; "
          f"expected {CODEC2_P} +- 5 sd = {5 * sd / rows:.4f})")
    check(abs(fired - CODEC2_P * rows) <= 5 * sd,
          f"codec2 degraded {fired} of {rows} rows, beyond 5 sd of "
          f"{CODEC2_P}")
    return paths


def _encode_codec2(tmp):
    """(b): util_scripts encode-codec2 over CODEC2_WAVS seeded 2 s wavs;
    each output against the in-process Codec2RoundTrip written as the
    tool writes it, bit for bit."""
    from pase_tpu_torch import util_scripts
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.data.host_distortions import Codec2RoundTrip
    from pase_tpu_torch.data.io import read_wav, write_wav
    src, out = os.path.join(tmp, "wavs"), os.path.join(tmp, "coded")
    os.makedirs(src)
    rows = next(iter(SyntheticChunkBatcher(CODEC2_WAVS, TRAIN_CHUNK,
                                           seed=26)))["chunk"]
    names = [f"utt{i:03d}.wav" for i in range(CODEC2_WAVS)]
    for name, row in zip(names, rows):
        write_wav(os.path.join(src, name), row)
    reset_launches()
    t0 = time.perf_counter()
    n = util_scripts.main(["encode-codec2", src, out, "--kbps",
                           str(CODEC2_KBPS)])
    wall = time.perf_counter() - t0
    launches = read_launches()
    c2 = Codec2RoundTrip(kbps=CODEC2_KBPS)
    bad = []
    for name in names:
        x, _ = read_wav(os.path.join(src, name))
        want = (np.clip(c2(x).astype(np.float64), -1, 1)
                * 32767.0).astype("<i2")
        got, _ = read_wav(os.path.join(out, name))
        if not np.array_equal(got * 32768, want):
            bad.append(name)
    audio_s = CODEC2_WAVS * TRAIN_CHUNK / SR
    print(f"[host-stage] (b) util_scripts encode-codec2 --kbps "
          f"{CODEC2_KBPS} (8 threads) over {CODEC2_WAVS} seeded 2 s wavs: "
          f"{wall:.2f} s, {audio_s / wall:.1f} audio-s/s; outputs equal to "
          f"the in-process Codec2RoundTrip bit for bit: "
          f"{CODEC2_WAVS - len(bad)} of {CODEC2_WAVS}")
    check(n == CODEC2_WAVS and not bad,
          f"encode-codec2: {n} files, {bad[:3]} differ")
    check(not any(launches.values()), f"encode-codec2 launched {launches}")
    return launches


def _decoders():
    """(c): SpectrogramDecoder at SPEC_DEC_SHAPE and the SpectrumLM
    rollout (LM_LAYERS x LSTM LM_RNN, LM_OUT bins, LM_BATCH rows,
    LM_STEPS steps, a forced frame, the state passed in) on the card
    against the CPU, float32 (TF32 off), with ms. Returns the launches
    (none: no QRNN)."""
    import torch
    from pase_tpu_torch import decoders
    gen = torch.Generator().manual_seed(26)
    b, t, c = SPEC_DEC_SHAPE
    dec = decoders.SpectrogramDecoder(c, generator=gen).eval()
    lm = decoders.SpectrumLM(LM_RNN, LM_LAYERS, LM_OUT,
                             generator=gen).eval()
    x = torch.randn(b, t, c, generator=gen)
    seed = torch.randn(LM_BATCH, LM_OUT, generator=gen)
    state = lm.init_state(LM_BATCH, gen)
    cps = {LM_STEPS // 2: torch.randn(LM_BATCH, LM_OUT, generator=gen)}
    with torch.no_grad():
        y_cpu = dec(x)
        f_cpu, _ = lm(seed, LM_STEPS, state=state, dec_cps=cps)
    dec.to("cuda")
    lm.to("cuda")
    xg, sg = x.cuda(), seed.cuda()
    stg = tuple(tuple(v.cuda() for v in s) for s in state)
    cg = {k: v.cuda() for k, v in cps.items()}
    reset_launches()
    with torch.no_grad():
        y = dec(xg)
        f, _ = lm(sg, LM_STEPS, state=stg, dec_cps=cg)
        torch.cuda.synchronize()
        launches = read_launches()
        dec_ms = _wall_ms(lambda: dec(xg), "cuda", reps=5)
        lm_ms = _wall_ms(lambda: lm(sg, LM_STEPS, state=stg, dec_cps=cg),
                         "cuda", reps=3)
    errs = [((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item(),
            ((f.cpu() - f_cpu).abs().max() / f_cpu.abs().max()).item()]
    print(f"[host-stage] (c) SpectrogramDecoder {list(SPEC_DEC_SHAPE)} -> "
          f"{list(y.shape)}: card vs CPU {errs[0]:.2e} of max|y| (bound "
          f"{DEC_REL}), {dec_ms:.3f} ms on the card; SpectrumLM "
          f"{LM_LAYERS} x LSTM {LM_RNN}, out {LM_OUT}, B={LM_BATCH}, "
          f"{LM_STEPS} closed-loop steps -> {list(f.shape)}: {errs[1]:.2e} "
          f"of max|y|, {lm_ms:.2f} ms ({lm_ms / LM_STEPS:.3f} ms a step); "
          f"launches {launches}")
    check(tuple(y.shape) == (b, t, 513) and tuple(f.shape) == (
        LM_BATCH, LM_STEPS, LM_OUT), f"decoder shapes {y.shape} {f.shape}")
    check(all(e <= DEC_REL for e in errs), f"decoders card vs CPU {errs}")
    check(not any(launches.values()), f"the decoders launched {launches}")
    return launches


def _dropout_masks():
    """(e): nn.dropout's masks on the card from a CUDA generator at
    MASK_SHAPE: the same seed bit for bit, the keep share within 5
    binomial sd of 1 - MASK_P, and two ranks' rows (row_shard, 3 streams
    of 16 of 32 rows) of the one global draw, bit for bit."""
    import torch
    from pase_tpu_torch.nn import dropout
    from pase_tpu_torch.parallel import mesh
    x = torch.rand(MASK_SHAPE, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    x = x + 0.5
    gen = torch.Generator(device="cuda")
    a = dropout(x, MASK_P, gen.manual_seed(7))
    b = dropout(x, MASK_P, gen.manual_seed(7))
    n = x.numel()
    kept = int((a != 0).sum())
    sd = (n * MASK_P * (1 - MASK_P)) ** 0.5
    per, total = MASK_SHAPE[0] // 6, MASK_SHAPE[0] // 3
    rows_ok = []
    for r in range(2):
        idx = torch.cat([torch.arange(s * total + r * per,
                                      s * total + (r + 1) * per)
                         for s in range(3)]).cuda()
        with mesh.row_shard(mesh.RowShard(r * per, (r + 1) * per, total)):
            got = dropout(x[idx], MASK_P, gen.manual_seed(7))
        rows_ok.append(torch.equal(got, a[idx]))
    print(f"[host-stage] (e) dropout masks on the card ({list(MASK_SHAPE)}, "
          f"p {MASK_P}, a CUDA generator): the same seed bit for bit "
          f"{torch.equal(a, b)}; kept {kept / n:.5f} (expected "
          f"{1 - MASK_P} +- 5 sd = {5 * sd / n:.5f}); two ranks' rows of "
          f"the one global draw bit for bit: {rows_ok}")
    check(torch.equal(a, b), "dropout: one seed, two masks")
    check(abs(kept - (1 - MASK_P) * n) <= 5 * sd,
          f"dropout kept {kept} of {n}")
    check(all(rows_ok), "dropout: a rank's rows are not the global draw's")


def phase_host_stage(tmp, common, synthetic_rate):
    """Phase 26: the host distortion stage, encode-codec2, the decoders,
    the attention variant on two ranks, the dropout masks. Returns
    {path: launches}."""
    import torch
    paths = _host_stage_cli(os.path.join(tmp, "cli"), common,
                            synthetic_rate)
    torch.cuda.empty_cache()
    paths["encode_codec2"] = _encode_codec2(os.path.join(tmp, "codec2"))
    paths["decoders"] = _decoders()
    torch.cuda.empty_cache()
    tmp_dp = os.path.join(tmp, "dp_attention")
    paths["dp_attention"] = _dp_compare(
        tmp_dp, dict(_dp_cfg(os.path.join(tmp_dp, "ranks")),
                     batch_size=ATT_BATCH, att_cfg=ATT_CFG),
        _dp_batches(ATT_BATCH), "(d) the attention variant's step",
        "dp_attention")[0]
    _dropout_masks()
    torch.cuda.empty_cache()
    return paths


def _tp_cfg(tmp, name):
    return dict(_dp_cfg(os.path.join(tmp, "ranks")),
                n_model=TP_GRIDS[name][1])


def _tp_batches():
    """The grids' compare step: phase 25's first batch."""
    return _dp_batches()[:1]


def _tp_start(tmp, name):
    """The ranks of the grid ``name``, started (``_tp_step`` joins them)."""
    world = TP_GRIDS[name][0]
    rate_steps = 0 if name == "1x2" else TP_RATE_STEPS
    return _start_ranks("--dp-step", _dp_spec(_tp_cfg(tmp, name),
                                              _tp_batches(), rate_steps),
                        os.path.join(tmp, "ranks"), world)


def _tp_step(tmp, name, ref, joined):
    """(a) / (b): PASE+ / workers+ on the grid ``name`` of TP_GRIDS against
    the one process ``ref`` (phase 25's rule); (b)'s ranks then time
    TP_RATE_STEPS bf16 steps after one warm-up ((a)'s bf16 rate is its
    CLI's, (c)); (d) the bytes a rank holds. Returns the ranks' summed
    launches."""
    import statistics
    world, n_model = TP_GRIDS[name]
    part = "(a)" if name == "1x2" else "(b)"
    rate_steps = 0 if name == "1x2" else TP_RATE_STEPS
    print(f"[n-model] {part} the {name} grid: a rank's "
          + k2_route(TP_SHAPES[name]))
    launches, ranks = _dp_compare(
        tmp, _tp_cfg(tmp, name), _tp_batches(),
        f"{part} the {name} grid's step", f"tp_step_{name}", world=world,
        rate_steps=rate_steps, ref=ref, joined=joined)
    if rate_steps:
        print(f"[n-model] {part} the {name} grid, bf16: steady steps/s per "
              f"rank (the median of {rate_steps} after one warm-up; the "
              f"{world} ranks share the card) " + ", ".join(
                  f"{1e3 / statistics.median(r['rate_ms']):.3f}"
                  for r in ranks)
              + f"; one process {1e3 / statistics.median(ref['rate_ms']):.3f}"
              f" (K2 at {list(TP_SHAPES[name])} per rank)")
    params, moments = zip(*(r["bytes"] for r in ranks))
    one_p, one_m = ref["bytes"]
    want = ref["want_bytes"][n_model]
    print(f"[n-model] (d) the {name} grid: parameter bytes per rank "
          f"{list(params)} (expected {want}: a sharded leaf's 1 / {n_model}, "
          f"a replicated one whole), Adam moment bytes {list(moments)}; one "
          f"process {one_p} and {one_m}: {params[0] / one_p:.4f}x")
    check(all(p == want for p in params),
          f"{name}: a rank holds {params} parameter bytes, not {want}")
    check(all(m == 2 * p for p, m in zip(params, moments)),
          f"{name}: the Adam moments {moments} are not twice the parameters")
    return launches


def _tp_cli_start(tmp):
    """(c)'s CLI ranks, started (``_tp_cli`` joins them)."""
    argv = ["--synthetic", "--net_cfg", WORKERSP_CFG, "--fe_cfg", PASEP_CFG,
            "--batch_size", str(TRAIN_BATCH), "--chunk_size",
            str(TRAIN_CHUNK), "--compute_dtype", "bfloat16", "--epoch", "1",
            "--log_freq", "1", "--save_path", os.path.join(tmp, "run"),
            "--n_model", str(TP_CLI_MODEL)]
    return time.perf_counter(), _start_ranks(
        "--cli-rank", {"argv": argv, "steps": TP_CLI_STEPS},
        os.path.join(tmp, "ranks"), TP_CLI_MODEL)


def _tp_cli(tmp, ref, started):
    """(c): the training CLI at --n_model TP_CLI_MODEL in gloo processes
    (--cli-rank) for a TP_CLI_STEPS epoch (each step logged: a rank's bf16
    steady step is the time from the second row to the last, (a)'s rate);
    its checkpoint resumed in one process and its FE_e0.npz that
    process's encoder bit for bit. Returns the ranks' summed launches."""
    import math
    import statistics
    import torch
    from pase_tpu_torch.frontend import wf_builder
    from pase_tpu_torch.trainer import Trainer
    save = os.path.join(tmp, "run")
    t0, started = started
    ranks = _join_ranks(started)
    wall = time.perf_counter() - t0
    launches = {k: sum(r["launches"][k] for r, _ in ranks)
                for k in ranks[0][0]["launches"]}
    res, text = ranks[0]
    grid = f"mesh: {{'data': 1, 'model': {TP_CLI_MODEL}}}"
    check(grid in text, f"tp_cli: rank 0 did not print {grid!r}")
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    vals = [v for r in recs if r["split"] in ("train", "eval")
            for k, v in r.items() if k not in ("t", "split", "step")]
    check(vals and all(math.isfinite(v) for v in vals),
          "tp_cli: a logged loss is not finite")
    rates = []
    for rank, (_, out) in enumerate(ranks):
        rows = recs if rank == 0 else _rank_rows(out, rank)
        t = [r["t"] for r in rows if r["split"] == "train"]
        rates.append((len(t) - 1) / (t[-1] - t[0]))
    one = Trainer(PASEP_CFG, WORKERSP_CFG, _dp_cfg(save), device="cuda")
    step = one.try_resume()
    check(step == res["bpe"], f"tp_cli: one process resumed at {step}, not "
          f"{res['bpe']}")
    enc = wf_builder(PASEP_CFG, device="cuda")
    enc.load_pretrained(os.path.join(save, "FE_e0.npz"))
    mine = one.model.frontend.state_dict()
    same = all(torch.equal(v, mine[k])
               for k, v in enc.module.state_dict().items())
    layers, steps, evals = res["layers"], res["bpe"], res["va_bpe"]
    print(f"[n-model] (c) python -m pase_tpu_torch.train --synthetic "
          f"--n_model {TP_CLI_MODEL} in {TP_CLI_MODEL} gloo processes on the "
          f"card ({TRAIN_BATCH} x {TRAIN_CHUNK}, bf16, {steps} steps + "
          f"{evals} eval): {wall:.1f} s; every logged loss finite; its "
          f"checkpoint resumed in one process at step {step} (strict), "
          f"FE_e0.npz that process's encoder bit for bit: {same}")
    print(f"[n-model] (a) the 1x2 grid, bf16: steady steps/s per rank (its "
          f"CLI's steps after the first; the {TP_CLI_MODEL} ranks share the "
          "card) "
          + ", ".join(f"{v:.3f}" for v in rates)
          + f"; one process {1e3 / statistics.median(ref['rate_ms']):.3f} "
          f"(K2 at {list(TP_SHAPES['1x2'])} per rank)")
    check(same, "tp_cli: FE_e0.npz is not the resumed encoder")
    expected = {**{k: 0 for k in launches},
                "qrnn_pool_fwd_train": TP_CLI_MODEL * layers * steps,
                "qrnn_pool_bwd": TP_CLI_MODEL * layers * steps,
                k1_eval(TP_SHAPES["1x2"]): TP_CLI_MODEL * layers * evals}
    print(f"[launches] tp_cli: {launches} (expected {expected})")
    check(launches == expected, f"tp_cli launches {launches} != {expected}")
    del one, enc
    torch.cuda.empty_cache()
    return launches


def _rank_rows(text, rank):
    """The metric records a rank > 0 printed (``log.MetricLogger``)."""
    tag = f"[rank {rank}] "
    return [json.loads(line[len(tag):]) for line in text.splitlines()
            if line.startswith(tag)]


def phase_tp(tmp):
    """Phase 27: column-parallel compute (--n_model) on gloo ranks sharing
    the card, the grids held to one one-process run. Each set of ranks
    starts while this process works on the last (the one-process run, a
    comparison); the rates come from steps no other process shares.
    Returns {path: launches}."""
    import torch
    tmps = {name: os.path.join(tmp, name) for name in TP_GRIDS}
    started = _tp_start(tmps["1x2"], "1x2")
    ref = _one_process(os.path.join(tmp, "one"),
                       _dp_cfg(os.path.join(tmp, "one")), _tp_batches(),
                       TP_RATE_STEPS, {n for _, n in TP_GRIDS.values()})
    joined = _join_ranks(started)
    started = _tp_start(tmps["2x2"], "2x2")
    paths = {"tp_step_1x2": _tp_step(tmps["1x2"], "1x2", ref, joined)}
    joined = _join_ranks(started)
    cli = _tp_cli_start(os.path.join(tmp, "cli"))
    paths["tp_step_2x2"] = _tp_step(tmps["2x2"], "2x2", ref, joined)
    torch.cuda.empty_cache()
    paths["tp_cli"] = _tp_cli(os.path.join(tmp, "cli"), ref, cli)
    return paths


def _row(name, source, replaces, launches, err, ms, plain_ms, bnd,
         library_ms=None, paths=None, **extra):
    """A kernel's summary; ``paths``: {path: its launches there}, each
    path's counts reset to 0 just before it and read just after;
    ``extra``: more keys (the shape the times are at, a latency floor)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms,
            "paths": {p: c.get(name, 0) for p, c in (paths or {}).items()},
            **extra}


def lane_child(tmp, args_path, out):
    """Phases 22-25 and 27 in a process of their own (``_lane_start``),
    beside the main process's phases 10-21 and 26: {path: launches} go to
    ``out`` (JSON). ``args_path``: the main process's start (time.time())
    and phase 8's rates."""
    from pase_tpu_torch import train as train_cli
    from pase_tpu_torch.precision import full_precision
    with open(args_path) as f:
        args = json.load(f)
    full_precision()
    train_cli.SYNTHETIC_BPE = CLI_STEPS     # every --synthetic CLI epoch
    dist_perf = args["dist_perf"]
    rate = dist_perf["bfloat16"]["steps_per_sec"]
    paths = {}
    try:
        for phase, run in (
                (22, lambda: phase_options(os.path.join(tmp, "options"),
                                           rate)),
                (23, lambda: phase_ami(os.path.join(tmp, "ami"), dist_perf)),
                (24, lambda: phase_kaldi(os.path.join(tmp, "kaldi"), rate)),
                (25, lambda: phase_parallel(os.path.join(tmp, "parallel"))),
                (27, lambda: phase_tp(os.path.join(tmp, "tp")))):
            paths.update(run())
            _clock(phase, args["t0"])
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        _end_children()
    with open(out, "w") as f:
        json.dump(paths, f)
    return 0


def _lane_start(tmp, t0, dist_perf):
    """``lane_child``'s process, on LANE_THREADS threads."""
    os.makedirs(tmp, exist_ok=True)
    args, out = (os.path.join(tmp, n) for n in ("args.json", "paths.json"))
    with open(args, "w") as f:
        json.dump({"t0": t0, "dist_perf": dist_perf}, f)
    log = os.path.join(tmp, "lane.log")
    return {"started": _background(["--lane", tmp, args, out], log,
                                   threads=LANE_THREADS),
            "out": out, "log": log, "shown": 0}


def _lane_show(lane):
    """Prints the lane's whole lines not printed yet."""
    with open(lane["log"], "rb") as f:
        f.seek(lane["shown"])
        text = f.read()
    text = text[:text.rfind(b"\n") + 1]
    lane["shown"] += len(text)
    print(text.decode(errors="replace"), end="", flush=True)


def _lane_join(lane):
    """The lane's {path: launches}, its output printed."""
    proc, _ = lane["started"]
    try:
        proc.wait(timeout=LANE_TIMEOUT)
    except subprocess.TimeoutExpired:
        _end_group(proc.pid)
        proc.wait()
    _lane_show(lane)
    check(proc.returncode == 0, f"phases 22-25 and 27 (their own process) "
          f"exited {proc.returncode}")
    with open(lane["out"]) as f:
        return json.load(f)


def _clock(phases, t0):
    print(f"[clock] phase {phases} done at {time.time() - t0:.1f} s",
          flush=True)


def main():
    if not os.path.isdir(os.path.join(HERE, "pase_tpu_torch")):
        print("FAIL: the pase_tpu_torch package is not beside chip_smoke.py",
              flush=True)
        return 1
    sys.path.insert(0, HERE)
    from pase_tpu_torch import train as train_cli
    train_cli.SYNTHETIC_BPE = CLI_STEPS     # every --synthetic CLI epoch
    tmp = tempfile.mkdtemp(prefix="pase_chip_train_")
    t0 = time.time()
    lane = None

    def clock(phases):
        # between two phases: the lane's lines so far, then the clock
        if lane is not None:
            _lane_show(lane)
        _clock(phases, t0)

    try:
        name = phase_device()
        import torch
        phase_build()
        rows, floor_ms = phase_kernel()
        train_rows = phase_kernel_train()
        clock("1-3, 6")
        reset_launches()                    # the serving path starts here
        enc, enc_calls = phase_encoder("cuda")
        calls = _calls_sum(enc_calls, phase_serve(enc, "cuda"))
        serving_launches = read_launches()  # ... and ends here
        layers = len(enc.module.rnn.layers)
        expected = {**{k: 0 for k in serving_launches},
                    **k1_calls(enc.module, calls)}
        print(f"[launches] serving path: {serving_launches} (expected "
              f"{expected}: {layers} QRNN layer(s) x encoder calls "
              + ", ".join(f"{n} at [{b},{t},512]"
                          for (b, t), n in calls.items()) + ")")
        check(serving_launches == expected,
              f"serving launches {serving_launches} != {expected}")
        phase_operator(enc)
        del enc
        clock("4-5")
        phase_train_parity(os.path.join(tmp, "parity"))
        tr, train_launches, _ = phase_train_cli(os.path.join(tmp, "cli"))
        phase_profile(tr)
        del tr
        clock(7)
        dist_perf = {}
        for dtype in ("bfloat16", "float32"):
            tr, _, dist_perf[dtype] = phase_train_dist(
                os.path.join(tmp, "dist_" + dtype), dtype)
            phase_profile(tr, f"distorted train step, {dtype}")
            del tr
            torch.cuda.empty_cache()
        check_bench_distortions()
        clock(8)
        convs = phase_conv()
        clock(9)
        paths = {"serving": serving_launches, "training": train_launches}
        stream_paths, k1 = phase_stream()
        paths.update(stream_paths)
        torch.cuda.empty_cache()
        clock(13)
        # every phase above runs alone; the rest share the host and the
        # card with the gate, the rehearsal, phase 11's process and the
        # lane of phases 22-25 and 27, so their rates are not alone
        gate = _gate_start(os.path.join(tmp, "gate"))
        rehearsal = _rehearsal_start(os.path.join(tmp, "rehearsal"))
        resume = _resume_start(os.path.join(tmp, "resume"))
        lane = _lane_start(os.path.join(tmp, "lane"), t0, dist_perf)
        torch.set_num_threads(SHARED_THREADS)
        phase_trajectory(os.path.join(tmp, "trajectory"))
        torch.cuda.empty_cache()
        clock(10)
        _, disk_common = phase_disk(os.path.join(tmp, "disk"),
                                    dist_perf["bfloat16"]["steps_per_sec"])
        clock(12)
        paths["export"] = phase_export()
        phase_overlap()
        clock("14-15")
        paths.update(phase_variants_train(
            os.path.join(tmp, "variants"),
            dist_perf["bfloat16"]["steps_per_sec"]))
        paths.update(phase_variants_serve())
        clock("16-17")
        paths.update(phase_gan(os.path.join(tmp, "gan")))
        clock(18)
        paths.update(phase_probes(os.path.join(tmp, "probes"),
                                  _gate_join(gate)))
        clock(19)
        paths.update(phase_recurrent(os.path.join(tmp, "recurrent")))
        clock(20)
        paths.update(phase_encoders(os.path.join(tmp, "encoders"),
                                    dist_perf["bfloat16"]["steps_per_sec"]))
        clock(21)
        paths.update(phase_host_stage(
            os.path.join(tmp, "host_stage"), disk_common,
            dist_perf["bfloat16"]["steps_per_sec"]))
        clock(26)
        _resume_join(resume)
        clock(11)
        paths.update(_rehearsal_join(rehearsal))
        clock(28)
        paths.update(_lane_join(lane))
        lane = None
        clock("22-25, 27 joined")
        trained = phase_trained_gates(
            os.path.join(tmp, "rehearsal", "work", "runA"))
        clock("the trained gates")
    except SmokeFailure as e:
        if lane is not None:
            _lane_show(lane)
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        _end_children()
        shutil.rmtree(tmp, ignore_errors=True)
    src = "pase_tpu_torch/csrc/qrnn_pool.cu"
    # the few-lane kernel at the serving shape; the eval kernel at the eval
    # shape of the training path, where it runs; the one-thread-a-lane one
    # there too (seeded calls on as many lanes take it; no path makes
    # one); the segmented one at a 1 s push at B=1 (phase 13 prints it at
    # all four push shapes)
    serving = next(r for r in rows if tuple(r["shape"]) == SERVING_SHAPE)
    long = next(r for r in rows if tuple(r["shape"]) == LONG_SHAPE)
    # the few-lane kernel at B = 1 extraction's [1,200,512] (the probes'
    # calls), and at each of FEW_SHAPES beside both floors and its bound,
    # on random, slow and frozen gates
    b1 = next(r for r in rows if tuple(r["shape"]) == FEW_SHAPES[0])
    few_at = {"x".join(map(str, r["shape"])): {
        "ms": r["few_turns"]["few"],
        "stream_floor_ms": r["few_turns"]["stream_floor"],
        "empty_ms": r["few_turns"]["empty"], "bound_ms": r["bound_ms"],
        "gates": r.get("few_gates", {})}
        for r in rows if r["few_turns"]}
    # the split kernel at every QRNN shape, and where the route sends it
    split_at = {"x".join(map(str, r["shape"])): {
        "ms": r["split_ms"], "bound_ms": r["bound_ms"],
        "routed": r["route"] == "qrnn_pool_fwd_split",
        "before_ms": r["before_ms"], "before": r["before_route"]}
        for r in rows}
    evals = next(r for r in rows if tuple(r["shape"]) == TRAIN_SHAPE)
    train = next(r for r in train_rows
                 if tuple(r["shape"]) == TRAIN_SHAPE)
    push = k1[(1, 100)]
    # phase 21's TDNN shapes (H = 256): the serving batch (K1 few-lane), the
    # recipe's eval (K1's eval kernel) and its train step (K2)
    tdnn_serve = next(r for r in rows
                      if tuple(r["shape"]) == TDNN_SERVING_SHAPE)
    tdnn_eval = next(r for r in rows if tuple(r["shape"]) == TDNN_TRAIN_SHAPE)
    tdnn_train = next(r for r in train_rows
                      if tuple(r["shape"]) == TDNN_TRAIN_SHAPE)
    # phase 22's shapes: the attention recipe's (K1's eval kernel in eval,
    # K2) and with a regularizer's fourth stream; phase 20's cut WaveRNN
    # CLI's eval
    att_eval, regu_eval = (next(r for r in rows if tuple(r["shape"]) == sh)
                           for sh in (ATT_TRAIN_SHAPE, REGU_TRAIN_SHAPE))
    att_train, regu_train = (next(r for r in train_rows
                                  if tuple(r["shape"]) == sh)
                             for sh in (ATT_TRAIN_SHAPE, REGU_TRAIN_SHAPE))
    wavernn_eval = next(r for r in rows if tuple(r["shape"]) == (
        48, WAVERNN_CLI_CHUNK // 160, 512))

    # phase 26 (d)'s per-rank shape: 8 rows x 3 streams
    dpa_train = next(r for r in train_rows
                     if tuple(r["shape"]) == (3 * ATT_BATCH // DP_RANKS,
                                              200, 512))
    # phase 27's lane shards: K1's eval kernel and K2 at [96,200,256] (1 x
    # 2) and [48,200,256] (2 x 2)
    tp_eval = {g: next(r for r in rows if tuple(r["shape"]) == sh)
               for g, sh in TP_SHAPES.items()}
    tp_train = {g: next(r for r in train_rows if tuple(r["shape"]) == sh)
                for g, sh in TP_SHAPES.items()}

    def tdnn(row, ms, plain, bnd):
        return {"shape": row["shape"], "ms": row[ms],
                "plain_ms": row[plain], "bound_ms": bnd[0],
                "bound_by": bnd[1]}

    print(json.dumps({"kernels": [
        _row("qrnn_pool_fwd_split", src, "pase_tpu/ops/pallas_qrnn.py:63",
             paths["forward_chunk_100s"]["qrnn_pool_fwd_split"],
             max(r["split_err"] for r in rows), long["split_ms"],
             long["plain_ms"], (long["bound_ms"], long["bound_by"]),
             paths=paths, shape=list(LONG_SHAPE), floor_ms=floor_ms,
             serving=tdnn(serving, "split_ms", "plain_ms", (
                 serving["bound_ms"], serving["bound_by"])),
             shapes=split_at),
        _row("qrnn_pool_fwd_few", src, "pase_tpu/ops/pallas_qrnn.py:63",
             serving_launches["qrnn_pool_fwd_few"],
             max(r["few_err"] for r in rows), b1["few_turns"]["few"],
             b1["plain_ms"], (b1["bound_ms"], b1["bound_by"]),
             paths=paths, shape=list(FEW_SHAPES[0]),
             floor_ms=b1["few_turns"]["empty"],
             stream_floor_ms=b1["few_turns"]["stream_floor"], shapes=few_at,
             serving=tdnn(serving, "few_ms", "plain_ms", (
                 serving["bound_ms"], serving["bound_by"])),
             tdnn=tdnn(tdnn_serve, "few_ms", "plain_ms", (
                 tdnn_serve["bound_ms"], tdnn_serve["bound_by"])),
             trained=trained),
        _row("qrnn_pool_fwd_seg", src, "pase_tpu/ops/pallas_qrnn.py:63",
             paths["stream"]["qrnn_pool_fwd_seg"],
             max([r["seg_err"] for r in rows]
                 + [r["err"] for r in k1.values()]), push["ms"],
             push["plain_ms"], (push["bound_ms"], push["bound_by"]),
             paths=paths, shape=[1, 100, 512], floor_ms=push["floor_ms"]),
        _row("qrnn_pool_fwd_eval", src, "pase_tpu/ops/pallas_qrnn.py:63",
             train_launches["qrnn_pool_fwd_eval"],
             max(r["eval_err"] for r in rows), evals["eval_ms"],
             evals["plain_ms"], (evals["bound_ms"], evals["bound_by"]),
             paths=paths, shape=list(TRAIN_SHAPE),
             tdnn=tdnn(tdnn_eval, "eval_ms", "plain_ms", (
                 tdnn_eval["bound_ms"], tdnn_eval["bound_by"])),
             attention=tdnn(att_eval, "eval_ms", "plain_ms", (
                 att_eval["bound_ms"], att_eval["bound_by"])),
             dp=tdnn(att_eval, "eval_ms", "plain_ms", (
                 att_eval["bound_ms"], att_eval["bound_by"])),
             regu=tdnn(regu_eval, "eval_ms", "plain_ms", (
                 regu_eval["bound_ms"], regu_eval["bound_by"])),
             wavernn=tdnn(wavernn_eval, "eval_ms", "plain_ms", (
                 wavernn_eval["bound_ms"], wavernn_eval["bound_by"])),
             **{("tp" if g == "1x2" else f"tp_{g}"): tdnn(
                 r, "eval_ms", "plain_ms", (r["bound_ms"], r["bound_by"]))
                for g, r in tp_eval.items()}),
        _row("qrnn_pool_fwd", src, "pase_tpu/ops/pallas_qrnn.py:63",
             train_launches["qrnn_pool_fwd"],
             max(r["loop_err"] for r in rows), evals["loop_ms"],
             evals["plain_ms"], (evals["bound_ms"], evals["bound_by"]),
             paths=paths, shape=list(TRAIN_SHAPE)),
        _row("qrnn_pool_fwd_train", src, "pase_tpu/ops/pallas_qrnn.py:82",
             train_launches["qrnn_pool_fwd_train"],
             max(r["fwd_err"] for r in train_rows), train["fwd_ms"],
             train["fwd_plain_ms"], train["fwd_bound"], paths=paths,
             tdnn=tdnn(tdnn_train, "fwd_ms", "fwd_plain_ms",
                       tdnn_train["fwd_bound"]),
             attention=tdnn(att_train, "fwd_ms", "fwd_plain_ms",
                            att_train["fwd_bound"]),
             dp=tdnn(att_train, "fwd_ms", "fwd_plain_ms",
                     att_train["fwd_bound"]),
             dp_attention=tdnn(dpa_train, "fwd_ms", "fwd_plain_ms",
                               dpa_train["fwd_bound"]),
             regu=tdnn(regu_train, "fwd_ms", "fwd_plain_ms",
                       regu_train["fwd_bound"]),
             **{("tp" if g == "1x2" else f"tp_{g}"): tdnn(
                 r, "fwd_ms", "fwd_plain_ms", r["fwd_bound"])
                for g, r in tp_train.items()}),
        _row("qrnn_pool_bwd", src, "pase_tpu/ops/pallas_qrnn.py:87",
             train_launches["qrnn_pool_bwd"],
             max(r["dy_abs"] for r in train_rows), train["bwd_ms"],
             train["bwd_plain_ms"], train["bwd_bound"], paths=paths,
             tdnn=tdnn(tdnn_train, "bwd_ms", "bwd_plain_ms",
                       tdnn_train["bwd_bound"]),
             attention=tdnn(att_train, "bwd_ms", "bwd_plain_ms",
                            att_train["bwd_bound"]),
             dp=tdnn(att_train, "bwd_ms", "bwd_plain_ms",
                     att_train["bwd_bound"]),
             dp_attention=tdnn(dpa_train, "bwd_ms", "bwd_plain_ms",
                               dpa_train["bwd_bound"]),
             regu=tdnn(regu_train, "bwd_ms", "bwd_plain_ms",
                       regu_train["bwd_bound"]),
             **{("tp" if g == "1x2" else f"tp_{g}"): tdnn(
                 r, "bwd_ms", "bwd_plain_ms", r["bwd_bound"])
                for g, r in tp_train.items()})]
        + [_conv_summary(name, *convs[dt], paths=paths)
           for dt, name in (("bfloat16", "conv_s1_tc"),
                            ("float32", "conv_s1_tf32x3"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--resume-check"]:        # phase 11's own process
        sys.path.insert(0, HERE)
        sys.exit(resume_check())
    if sys.argv[1:2] == ["--counted"]:            # phase 28's CLIs
        sys.exit(counted_child(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--det-ops"]:            # phase 28's listing
        sys.path.insert(0, HERE)
        sys.exit(det_ops_child(json.loads(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--lane"]:               # phases 22-25, 27
        sys.path.insert(0, HERE)
        sys.exit(lane_child(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--gate"]:               # phase 19's gate
        sys.path.insert(0, HERE)
        sys.exit(gate_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] in (["--dp-step"], ["--cli-rank"]):   # phase 25's ranks
        sys.path.insert(0, HERE)
        sys.exit(dp_child(sys.argv[1], sys.argv[2], int(sys.argv[3]),
                          int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit(main())
