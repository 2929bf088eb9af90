"""Launchers (port of the non-mesh half of `repro/launch/`): the step
builders (`steps.py`), the serving loop and the async federation service
(`serve.py`), and the reduced-scale training loop (`train.py`)."""
