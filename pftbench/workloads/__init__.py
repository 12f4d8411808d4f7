"""One loop per kind of traffic mix (a mix's ``kind``): its set-up, window
and comparison."""
