"""One module per kind of cell, found by a traffic mix's `kind`.

A kind module gives:

- ``run(cell, seed, seconds, trace, device, t_process)``: set up, warm
  up, measure for `seconds` and, with `trace`, trace a short window; an
  ``program.Outcome``;
- ``reference(cell, seed, device, readings=None, precision="float32",
  fault=None)``: the plain reference's readings, shaped as the
  program's, recomputed from the same generated inputs;
- ``numbers(readings, ref)``: what `correct` compares, by name;
- ``FAULTS``: the faults ``reference`` can plant, for ``calibrate.py``;
- ``counted_scene(cell, seed, device)`` -> (parameters, camera of an
  item), and ``parts(cell, counts)``: the least time of one item
  (``work/``).

The configuration's renderer (``renderers/``) supplies what depends on
the model. A later kind (the viewer's `/render` with its PNG encode, say)
is a file beside these.
"""
