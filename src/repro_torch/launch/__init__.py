"""Entry points: training (the train step, the trainer) and greedy-decode serving."""
