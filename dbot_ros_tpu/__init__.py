"""dbot_ros_tpu — accelerator-native depth-based Bayesian object tracking.

A from-scratch JAX/XLA/Pallas re-design of the bayesian-object-tracking
reference system (dbot_ros + dbot + fl): 6-DoF pose tracking of known rigid
objects from depth streams via a Rao-Blackwellized coordinate particle filter
and a robust multi-sensor Gaussian filter, with batched matmul raycasting in
place of the reference's OpenGL/CUDA render-and-score path.

Layout (mirrors SURVEY.md §7):
  utils/     pose algebra, meshes, cameras         (ref dbot/pose, object_model)
  models/    transition + observation models       (ref dbot/model, fl/model)
  ops/       raycast, resampling, sigma points     (ref dbot/gpu, fl quadrature)
  filters/   RBC-PF, (robust) Gaussian filters     (ref dbot filters, fl/filter)
  trackers/  tracker facades + config builders     (ref dbot/tracker, builder)
  runtime/   streaming loop, sources, metrics      (ref dbot_ros nodes)
  parallel/  multi-chip sharding + collectives     (new; ref has none)
  native/    C++ host runtime (IO, preprocessing)  (ref C++ plumbing)
"""

__version__ = "0.1.0"
