"""Reference families: the mathematics of one kind of model block.

A model entry of ``bench/configs/<config>.json`` names its family with
``"reference": "<name>"``, and the harness loads
``bench/reference/families/<name>.py`` by that name
(``bench.harness.spec.load_family``); without the key the family is
``gqa``.  A configuration whose block no family covers adds a module
here, and no harness file changes.  The spec each function takes is the
entry's ``"port"``.  A family module provides:

* ``make_params(spec, seed, device)``: the weights, made on the device
  from the seed, in the tree that the program's model takes;
* ``class_logits(spec, params, seqs, classes, precision)``: the class
  tokens' logits at each ``layers.Seq``'s last position, float32 with
  TF32 off, at ``precision`` ``"f32"`` and the control's ``"fp8"``, and
  at each precision that ``looks(spec)`` names;
* ``looks(spec)``: further precisions that show how far one part of the
  model alone moves an answer (``bench/tools/control.py`` reads them);
* work counts of one real token and one attention call, from logical
  shapes: ``active_params(spec)`` (parameters a token passes through in
  the layers), ``head_params(spec)`` (the head's rows times their
  width), ``attention_layers(spec)``, and ``extend_call(spec, docs)``
  over ``(cached, new)`` and ``decode_call(spec, kvs)`` over key counts,
  each the ``(operations, bytes)`` of one layer's call.
"""
