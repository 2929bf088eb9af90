"""Launchers (port of `repro/launch/` without its model meshes): the step
builders (`steps.py`), the serving loop and the async federation service
(`serve.py`), the reduced-scale training loop (`train.py`), and the
federation mesh on `torch.distributed` (`mesh.py`)."""
