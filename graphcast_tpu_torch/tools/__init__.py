"""The port's multi-step drivers, twins of the repository's ``tools/``
scripts: ``train_curve``, ``bench_gencast_rollout``, ``bench_train_025``,
``bench_train_gencast``, ``memdump_train_025`` and ``memdump_gencast``.
Each runs as ``python3 -m graphcast_tpu_torch.tools.<name>`` (common.py).
"""
