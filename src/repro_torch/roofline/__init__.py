"""Roofline analysis of the port's steps on the H100: the card's peaks
(``analysis``), an analytic model of a step's memory traffic
(``analytic``) and a count of the FLOPs and bytes of the ops a step
dispatches (``op_cost``)."""
