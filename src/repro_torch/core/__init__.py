"""Simulator, predictor and feature schema of the port."""
