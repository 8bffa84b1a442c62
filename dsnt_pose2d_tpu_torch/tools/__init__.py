"""The experiment drivers (ports of the JAX package's ``tools/``), each run
as ``python -m dsnt_pose2d_tpu_torch.tools.<name>``:

- :mod:`.ablation_heads`, :mod:`.ablation_resolution`, :mod:`.ablation_reg`:
  the paper's three ablation grids, train-then-evaluate runs of the port's
  CLIs (:mod:`.ablation_common`);
- :mod:`.flagship_report`: the hg8 multi-epoch report beside the device
  step's bench;
- :mod:`.dress_rehearsal`: a release-layout MPII stand-in, then the whole
  user chain over it;
- :mod:`.bench_infer`, :mod:`.sweep_train_step`, :mod:`.profile_step`:
  the serving bench per backbone, the train step over its knobs, and a
  trace of the flagship train step.

Each takes ``--device {cuda,cuda:N,cpu}`` (default ``cuda``, which raises
without a card) and passes it to every CLI or worker it starts.  Results go
under ``--data-dir`` or ``--out-dir``.
"""
