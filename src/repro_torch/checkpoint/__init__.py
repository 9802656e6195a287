"""Checkpoints: npz snapshots in the reference's file format."""
