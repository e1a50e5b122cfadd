"""The roofline of the port on one NVIDIA H100 (port of :mod:`repro.roofline`).

:mod:`.cost` counts a step's work and holds the kernels' bound formulas;
:mod:`.analysis` turns the dry run's records into the three-term roofline.
The reference's ``collectives.py`` parses XLA HLO for the wire bytes of a
mesh's collectives; its port, :mod:`.collectives`, counts the collectives
an ``spmd`` step issues (a worker record's ``collective_bytes``), and a
one-card dry-run record has none.
"""
