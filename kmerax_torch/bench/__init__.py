"""The `bench` subcommand's harness on one device: the timed presets
(runners.py), the acceptance configs (acceptance.py) and their read
simulator (sim.py)."""
