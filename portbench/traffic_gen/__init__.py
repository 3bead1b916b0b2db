"""Frozen traffic generators: what a traffic file's parameters and a run's
seed turn into as the program's inputs."""
