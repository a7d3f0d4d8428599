"""One module per renderer family, found by a configuration's `renderer`.

A renderer module gives what depends on the model and its rasterizer:

- ``draw_scene(cfg, seed, device)``: the raw parameters the run starts
  from, drawn from the seed;
- ``program_state(arrays, device)``: the port's state of those arrays;
- ``render(cfg, params, cam, background, prec)`` and
  ``train_step(cfg, params, mu, nu, count, cam, gt, background, extent,
  prec, rows=None)``: the plain reference (``reference/``);
- ``view_counts(cfg, params, cam)``: the work one view asks
  (``work/counts.py``);
- ``frame_parts(cfg, counts)`` and ``step_parts(cfg, counts)``: the least
  time of a served frame's and a training step's parts
  (``work/least_time.py``).

A later renderer (2DGS surfels, say) is a file beside this one.
"""
