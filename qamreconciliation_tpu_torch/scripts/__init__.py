"""The experiment campaigns: the port's counterparts of the JAX package's
``scripts/`` (file for file, under the same names).

Each campaign runs as ``python -m qamreconciliation_tpu_torch.scripts.<name>``
with the JAX script's flags plus ``--device`` (default ``cuda``) and, where
the JAX script writes fixed output files, ``--outdir`` (default
``qamreconciliation_tpu_torch/scripts/h100/``, ``docs/img/``'s file names).
A campaign prints one JSON record a config on stdout, after a first record
that names the device it ran on; a config that raises prints the JAX
script's ``"error"`` record, and the campaign exits 1 after the remaining
configs.  The ``plot_*`` modules draw the JAX plotters' figures from sweep
CSVs read with the standard library; only drawing needs matplotlib.

Campaigns: ``run_waterfall`` (one ``sim_reconciliation --qc`` sweep on a
built code), ``run_r5_dvbs2`` (DVB-S2 rate-1/2 waterfall, QC-against-exact-H
equivalence, rate-3/4 BSC), ``run_r5_knee``, ``run_bps4_grid``,
``run_oms_sweep``, ``run_r5_sp_grid``, ``run_r5_stream_grid`` and
``run_r5_mi_grid``.
"""
