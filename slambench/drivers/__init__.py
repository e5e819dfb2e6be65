"""Drivers: one per way of calling the program. A traffic file names its
driver; the driver makes the cell's inputs from the seed (with the
benchmark's simulator) and runs one job through the program's entry
point. Each module gives STAGES (what the check compares), make_inputs,
stage_calls and run_job."""
