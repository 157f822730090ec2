from .simulator import simulate_reads, SimRead, parse_truth_name
