from .log_parsing import Record, load_records, get_increasing_subsequence
