"""Traffic: each mix is a data file ``<mix>.json`` of parameters, and its
``kind`` names the module here that drives it (``train.py`` for closed-loop
training steps)."""
