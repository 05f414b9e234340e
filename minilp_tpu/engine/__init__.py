"""Device-side solver engines (revised simplex; PDHG first-order path).

Layer map position: the device equivalents of the reference's L3 (simplex engine),
L2 (basis solves) and the removed L1 (ordering — unnecessary for a dense-blocked
basis); see SURVEY.md §2.
"""
