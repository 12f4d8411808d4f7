import sys

from pftbench.run import main

sys.exit(main())
