"""Entry points: LM serving (``python -m repro_torch.launch.serve``) and
the test mesh (``launch.mesh``)."""
