"""How the harness builds the program's model for a configuration, one
module a family: a configuration's ``family`` names
``families/<family>.py`` (``harness.main.family``).  A family module
builds the port's model and its prepared parameters, makes the float
weights the plain reference reads (the same from the seed), and names the
program's functions whose inputs and outputs the check copies.  A new
model family is a new file here and a reference of its own."""
