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

The attribution probes time one part of the hot path each, with the JAX
probe's flags plus ``--device`` (``_probe.py``; exit 2 without a card
unless ``--device cpu``): ``probe_check_math`` (kernel 6: kernel 1's tiles
with three slot maths), ``probe_qc_parts`` (the dense iteration's data
movement against its check phase), ``probe_layered_parts`` (the layered
sweep against its parity test), ``probe_preamble`` (the softening preamble
stage by stage), ``probe_mcmi_parts`` (the batched MC-MI estimator and its
ablations) and ``probe_bf16pack`` (kernel 7: f32 against packed bf16).
``run_h100.sh`` runs all of it on the card.
"""
