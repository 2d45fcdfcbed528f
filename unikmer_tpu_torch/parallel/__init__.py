"""Sharding over a mesh of devices: mesh.py (the devices), sharded.py
(the hash-range sharded build and set operations behind ``--mesh``)."""
