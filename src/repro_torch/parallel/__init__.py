"""Sharding rules and activation anchors on a torch DeviceMesh."""
