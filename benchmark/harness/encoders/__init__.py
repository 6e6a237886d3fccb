"""The counts of the text encoders, one file each, named by a configuration's
``model.text_encoder`` (``benchmark/harness/counts.py`` is the trunk). Each
file gives:

- ``sizes(model)``: the encoder's sizes from the configuration's ``model``,
  with ``width``, the width of the token states it hands the trunk;
- ``forward_flops(m, x)``: model FLOPs of its forward;
- ``KERNELS``: ``{kind: (count function, calls a forward, name pattern)}``
  of its kernels: ``count(m, x)`` gives one call's ``(flops, bytes)``,
  ``calls(m)`` the calls a forward, the pattern (a Python regular
  expression) is searched in the profiler's kernel names.

``m`` is the trunk's ``counts.Model`` (the encoder's sizes in
``m.encoder``), ``x`` a ``counts.Shape``.
"""
