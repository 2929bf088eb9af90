"""Launchers (port of `repro/launch/`): the step builders and the lowering
for a mesh (`steps.py`), the serving loop and the async federation service
(`serve.py`), the reduced-scale training loop (`train.py`), the federation
and model meshes on `torch.distributed` (`mesh.py`), and the dry run over
the production meshes (`dryrun.py`)."""
