"""Dataset layer (numpy, host side), the port's copy of dpg_slam_tpu/io:

  dataset  — synthetic worlds (office, reading room), the raycaster and
             the sequence simulator
  logs     — .npz / .dsl sequence logs (native/ through ctypes, or the
             pure-Python reader of the same bytes)
  suites   — the gdc / mit suites and .json suite manifests
  rosbag1  — ROS1 .bag reader and writer
  convert  — recorded streams (bag, CSV, npz) to sequence logs
             (python -m dpg_slam_tpu_torch.io.convert)
"""
