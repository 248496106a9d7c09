"""Placement over devices: logical sharding axes resolved on a mesh."""
