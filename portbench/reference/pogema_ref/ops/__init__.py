"""Egocentric windows and the observation, by direct slicing."""
