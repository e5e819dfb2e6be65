"""Reference-equivalent baselines for benchmarking (the port's copy of
dpg_slam_tpu/baselines): the reference's per-keyframe work re-executed
serially on the host CPU, in numpy and in the native C++ harness
(native/serial_baseline.cc).
"""
