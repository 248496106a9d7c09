"""Entry points: LM serving (``python -m repro_torch.launch.serve``),
training (``python -m repro_torch.launch.train``, its step builders in
``launch.steps``) and the test mesh (``launch.mesh``)."""
