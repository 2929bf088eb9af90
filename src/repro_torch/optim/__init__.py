"""Client-held local optimizers and learning-rate schedules."""
