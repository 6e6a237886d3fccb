"""The reference's text encoders, one file each, named by a configuration's
``model.text_encoder``. Each file gives two functions, fp32 plain ``torch``
that imports nothing of the port:

- ``frame(tokens, token_mask, cfg)``: the collated ``[B, T]`` tokens and
  mask as the encoder's sequences (any object ``encode`` takes);
- ``encode(P, framed, seeds, cfg)``: the training forward over them (dropout
  on, seeds drawn from ``seeds`` in call order), the token states aligned
  back to the collated ``[B, T, D]``.

``cfg`` is the configuration's ``model`` and ``hyp`` with the cell's
``cls_sep`` ids; ``P`` the leaf tensors by the checkpoint's names. The
shared pieces (``splitmix32``, ``dropout``, ``attention_keep``,
``step_seeds``, ``_linear``, ``_ln``) are in :mod:`benchmark.reference.model`.
"""
