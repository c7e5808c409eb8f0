"""Static checks and the kernel-build artifact (port of
``proovread_tpu/analysis``).

- ``engine.py``: the AST rule engine, the violation model, the
  ``# static-ok:`` opt-out and the baseline ratchet;
- ``rules.py``: the AST rules ``naked-timer`` and ``host-sync-ast``;
- ``shapes.py``: the bucket tables, from the driver's own helpers;
- ``factory.py``: the kernel-build artifact and the boot child;
- ``__main__.py``: ``python -m proovread_tpu_torch.analysis check``.

The reference's jaxpr rules (``no-gather``, ``donation``, ``host-sync``
on jaxprs, ``wide-dtype``, ``packed-upcast``) walk traced XLA programs;
the port runs PyTorch eagerly and has no jaxpr to walk, so none has a
counterpart (``rules.py`` says why for each). Its ``entrypoints.py``,
``predict.py`` and ``budget.json`` enumerate and budget XLA programs per
shape; CUDA compiles one library for every shape, so what carries over
is the artifact manifest's program list and the boot's observed-within-
shipped reconciliation (``obs/boot.py``).
"""
